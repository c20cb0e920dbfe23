// Error text for the codes the kernel entry points return.
#include "common.cuh"

HPTMT_API const char* hptmt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
