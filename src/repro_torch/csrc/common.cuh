// Shared helpers of the HPTMT CUDA kernels.
//
// Every entry point has a plain C interface (bound with ctypes from
// repro_torch/kernels/native.py): pointers and the stream arrive as
// void*, sizes as int64_t, and the function returns cudaGetLastError()
// right after its launch so the Python wrapper can raise on a refused
// launch.  Kernels allocate nothing: the wrapper passes every output.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define HPTMT_API extern "C" __attribute__((visibility("default")))

namespace hptmt {

// Blocks for a grid-stride loop over n items: enough to fill the card's
// 132 SMs several times over, never more than the work needs.
inline unsigned grid_for(int64_t n, int threads, int64_t max_blocks = 132 * 16) {
    int64_t blocks = (n + threads - 1) / threads;
    if (blocks < 1) blocks = 1;
    if (blocks > max_blocks) blocks = max_blocks;
    return static_cast<unsigned>(blocks);
}

}  // namespace hptmt
