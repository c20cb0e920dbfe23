"""Variants of the bf16 tensor-core flash-attention kernel, side by side.

    python3 scripts/flash_variants.py [--variants p3,p2,p1,...] [--seeds 3]

Run from the root of a checkout on a machine with an NVIDIA H100.  Each
variant is ``src/repro_torch/csrc/flash_attention_sm90.cu`` with a few
source lines replaced (``VARIANTS``), built with the port's own flags into
``src/repro_torch/build/variants/<name>``.  For each it prints, one JSON
line each:

* ``check`` — the largest error against the plain version on small cases
  (``ok`` at bf16's 2e-2; the isolation variants compute something else
  on purpose and are timed only);
* ``time`` — kernel ms at the phi3-mini prefill (q/k/v (8, 32, 1024, 96))
  and the smollm prefill (8, 15/5, 1024, 64), CUDA events, mean of 20
  after a warm-up, in the order variants, then variants reversed, beside
  ``scaled_dot_product_attention``;
* ``fidelity`` — the share of bf16 outputs that differ from the plain
  ``attend`` path's at those shapes (the float32 SIMT kernel as ``simt``);
* ``logits`` — for the variants in ``--logit-variants``: full-size bf16
  phi3-mini and smollm prefills (8 prompts of 1024 tokens, weights from
  each seed, as ``chip_smoke.py`` phases 8-9) through the variant, the
  largest last-position logit difference from the plain path over the
  largest logit.

The variants: ``p3`` is the kernel as it is (P as three bf16 terms, each
tile's P·V summed afresh and added to O in float32); ``p2``/``p1`` carry
P in two terms or one (``p1`` rounds P to bf16 once, as the TPU's MXU
takes it); ``p3-tc-sum`` keeps O on the tensor cores across tiles; the
isolation variants drop one stage to price it: ``no-exp2`` (no
exponentials), ``no-qk`` (no S product), ``no-pv`` (no P·V product).
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
SOURCE = "flash_attention_sm90.cu"

VARIANTS = {
    "p3": [],
    "p2": [("constexpr int kParts = 3;", "constexpr int kParts = 2;")],
    "p1": [("constexpr int kParts = 3;", "constexpr int kParts = 1;")],
    "p3-tc-sum": [
        ("wgmma_rs(ot, a, vd, kk > 0 || part > 0);",
         "wgmma_rs(ot, a, vd, 1);"),
        ("""            float ot[N / 2];
            pv<N>(ot, pa, k_base + kChunks * kKVChunk);
#pragma unroll
            for (int i = 0; i < N / 2; ++i)
                o[i] = fmaf(o[i], (i & 2) ? a_hi : a_lo, ot[i]);""",
         """#pragma unroll
            for (int i = 0; i < N / 2; ++i) o[i] *= (i & 2) ? a_hi : a_lo;
            pv<N>(o, pa, k_base + kChunks * kKVChunk);""")],
    "no-exp2": [("? exp2f(sc[2 * j] - mn)", "? (sc[2 * j] - mn)"),
                ("? exp2f(sc[2 * j + 1] - mn)", "? (sc[2 * j + 1] - mn)")],
    "no-qk": [("wgmma_ss_n64(s, desc(qa, 16, 1024), desc(ka, 16, 1024), "
               "kk > 0);",
               "if (kk == 0) for (int i = 0; i < kBK / 2; ++i) "
               "s[i] = (qa + ka) * 1e-9f;")],
    "no-pv": [("wgmma_rs(ot, a, vd, kk > 0 || part > 0);",
               "if (kk == 0 && part == 0) for (int i = 0; i < N / 2; ++i) "
               "ot[i] = __uint_as_float(a[0]) + (float)vd;")],
}
ISOLATION = {"no-exp2", "no-qk", "no-pv"}
CHECK_CASES = [  # b, hq, hkv, sq, sk, d, causal, window, kv_len, q_offset
    (2, 4, 2, 128, 128, 64, True, None, None, 0),
    (1, 3, 1, 100, 100, 40, True, None, None, 0),
    (1, 4, 1, 1000, 1000, 96, True, None, None, 0),
    (1, 2, 2, 256, 256, 128, True, None, None, 0),
    (1, 6, 2, 1000, 1000, 64, True, 200, None, 0),
    (2, 4, 4, 1, 1096, 96, True, None, 1024, 1023),
]
SHAPES = {"phi3": (8, 32, 32, 96), "smollm": (8, 15, 5, 64)}


def emit(tag: str, **fields) -> None:
    print(json.dumps({"phase": tag, **fields}), flush=True)


def build_variant(native, name: str):
    """The kernel library with ``name``'s replacements in the sm90 source."""
    out = native.BUILD / "variants" / name
    csrc = out / "csrc"
    shutil.rmtree(csrc, ignore_errors=True)
    shutil.copytree(native.CSRC, csrc)
    text = (csrc / SOURCE).read_text()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} is not in {SOURCE}")
        text = text.replace(old, new)
    (csrc / SOURCE).write_text(text)
    return native.load(native.build(csrc=csrc, out=out))


def qkv(b, hq, hkv, sq, sk, d, gen, dev):
    """q/k/v as the model hands them over: (B, S, H, D) transposed."""
    x = torch.randn((b, sq, hq, d), generator=gen, device=dev)
    kv = torch.randn((b, sk, 2 * hkv, d), generator=gen, device=dev)
    x, kv = x.to(torch.bfloat16), kv.to(torch.bfloat16)
    return (x.transpose(1, 2), kv[:, :, :hkv].transpose(1, 2),
            kv[:, :, hkv:].transpose(1, 2))


def cuda_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--logit-variants", default="p3,p2,p1,simt",
                    help="variants (and simt: the float32 SIMT kernel on "
                    "float32 copies) whose prefill logits are compared")
    ap.add_argument("--seeds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch.nn.functional as F
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels import native
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.flash_attention import ops as fao
    from repro_torch.kernels.flash_attention import ref as far
    from repro_torch.models.layers import attend
    from repro_torch.models.transformer import LM
    from repro_torch.serve.engine import Engine, ServeConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    emit("card", nvidia_smi=chip_smoke.card_line())
    names = args.variants.split(",")
    libs = {name: build_variant(native, name) for name in names}

    def use(name):
        native._LIB = libs[name]  # the wrappers call native.library()

    gen = torch.Generator(device=dev).manual_seed(0)
    for name in names:
        use(name)
        worst = 0.0
        for case in CHECK_CASES:
            b, hq, hkv, sq, sk, d, causal, window, kv_len, qoff = case
            q, k, v = qkv(b, hq, hkv, sq, sk, d, gen, dev)
            kw = dict(causal=causal, window=window, kv_len=kv_len,
                      q_offset=qoff)
            got = fak.flash_attention_cuda(q, k, v, **kw).float()
            exp = far.flash_attention(q, k, v, **kw).float()
            err = (got - exp).abs()
            worst = max(worst, float((err / (1 + exp.abs())).max()))
        emit("check", variant=name, worst_rel_err=worst,
             ok=worst <= 2e-2, isolation=name in ISOLATION)

    pos = torch.arange(1024, device=dev, dtype=torch.int32)
    for shape, (b, hq, hkv, d) in SHAPES.items():
        q, k, v = qkv(b, hq, hkv, 1024, 1024, d, gen, dev)
        times = {}
        for name in names + names[::-1]:
            use(name)
            times.setdefault(name, []).append(
                cuda_ms(lambda: fak.flash_attention_cuda(q, k, v)))
        sdpa = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=hq != hkv))
        emit("time", shape=shape, ms=times, sdpa_ms=sdpa)
        plain = attend(q, k, v, q_pos=pos, kv_pos=pos)
        share = {}
        for name in names:
            use(name)
            share[name] = float((fak.flash_attention_cuda(q, k, v) != plain)
                                .float().mean())
        simt = fak.flash_attention_cuda(q.float(), k.float(), v.float())
        share["simt"] = float((simt.to(torch.bfloat16) != plain)
                              .float().mean())
        emit("fidelity", shape=shape, differ_share=share)

    logit_names = [n for n in args.logit_variants.split(",")
                   if n in libs or n == "simt"]
    bf16_kernel = fao.flash_attention

    def simt_path(q, k, v, **kw):
        return fak.flash_attention_cuda(q.float(), k.float(), v.float(),
                                        **kw).to(q.dtype)

    for arch in ("phi3-mini-3.8b", "smollm-360m"):
        cfg = get_config(arch)
        for seed in range(args.seeds):
            rng = np.random.default_rng(seed + 2)
            prompts = rng.integers(1, cfg.vocab_size, (8, 1024),
                                   dtype=np.int32)
            model = LM(cfg, torch.Generator(device=dev).manual_seed(seed),
                       dev)
            serve = chip_smoke.SERVE
            engine = Engine(model, ServeConfig(
                max_len=serve["prompt"] + serve["gen"] + 8))
            rel = {}
            chip_smoke.set_cfg(model, use_flash=False)
            plain = engine.prefill(prompts)[0]
            chip_smoke.set_cfg(model, use_flash=True)
            for name in logit_names:
                use(names[0] if name == "simt" else name)
                fao.flash_attention = (simt_path if name == "simt"
                                       else bf16_kernel)
                got = engine.prefill(prompts)[0]
                rel[name] = float((got - plain).abs().max()
                                  / plain.abs().max())
            fao.flash_attention = bf16_kernel
            emit("logits", arch=arch, seed=seed, rel=rel)
            del engine, model, plain
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
