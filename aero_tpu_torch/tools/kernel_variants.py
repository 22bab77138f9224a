"""Time variants of the tensor-core kernels on the card: what each part of
a kernel costs, and whether another block shape would be faster.

Run from the repository root, on a machine with one CUDA GPU:

    python3 -m aero_tpu_torch.tools.kernel_variants [lstm] [attention] [ftb] [backward]

(all four when none is named).

Each variant is a kernel source of ``aero_tpu_torch/csrc`` with one text
substitution (a part removed, a constant changed), written with its
library under ``build/aero_tpu_torch/variants`` (git-ignored)
and timed with CUDA events at the serving shapes, in bfloat16, beside the
unchanged source ("base"). A variant that removes a part computes another
function; the shape variants (attention forward and backward, FTB tail)
compute the same one, and those whose output is off the base output by
more than the bfloat16 tolerance are named. Prints one line per shape with
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

import chip_smoke as cs
from aero_tpu_torch.ops import _build, attention, ftb, lstm

OUT = _build.BUILD_DIR / "variants"

# csrc/lstm_mma.cu: the parts of a step
LSTM_PARTS = {
    "pointwise": (
        "        c[nt][j] = sigmoid(gf) * c[nt][j] + sigmoid(gi) * tanh_sfu(gg);\n"
        "        hv[j] = sigmoid(go) * tanh_sfu(c[nt][j]);",
        "        c[nt][j] = gf;\n"
        "        hv[j] = 0.01f * (gi + gg + go);"),
    "xp_staging": (
        "    stage_x(step + kStages - 1);  // into the buffer step - 1 read",
        "    aero::cp_async_commit();"),
    "out_store": (
        "      if (aligned && s < n) {\n"
        "        *reinterpret_cast<bf162*>(ot + s) = hp;",
        "      if (s == -7) {\n"
        "        *reinterpret_cast<bf162*>(ot + s) = hp;"),
    "mma": (
        "        mma_bf16(acc[0][nt], wa[0][kk], b0, b1);\n"
        "        mma_bf16(acc[1][nt], wa[1][kk], b0, b1);",
        "        acc[0][nt][0] += __uint_as_float(b0 ^ wa[0][kk][0]);\n"
        "        acc[1][nt][1] += __uint_as_float(b1 ^ wa[1][kk][1]);"),
    "barrier": (
        "    __syncthreads();  // ... for all; h_t is complete; h_{t-1} and xp_t are read",
        ""),
}
LSTM_ENTRY = """
extern "C" int variant_entry(const void* xp, const void* w, const void* b,
                             void* out, int t, int h, int n, int tile,
                             void* st) {
  return aero::lstm_recurrence_mma(xp, w, static_cast<const float*>(b), out,
                                   t, h, n, tile, static_cast<cudaStream_t>(st));
}
"""

# csrc/local_attention_mma.cu: block shape and occupancy
_BOUNDS = "__global__ void __launch_bounds__(kWarps * 32)\n"
_WARPS = "constexpr int kWarps = 4;"
_KEYS = "constexpr int kKeys = 64;"
ATTN_SHAPES = {
    "min_blocks_6": (_BOUNDS, _BOUNDS.replace("32)", "32, 6)")),
    "min_blocks_8": (_BOUNDS, _BOUNDS.replace("32)", "32, 8)")),
    "warps_2": (_WARPS, "constexpr int kWarps = 2;"),
    "warps_8": (_WARPS, "constexpr int kWarps = 8;"),
    "keys_32": (_KEYS, "constexpr int kKeys = 32;"),
    "keys_128": (_KEYS, "constexpr int kKeys = 128;"),
}
ATTN_ENTRY = """
extern "C" int variant_entry(const void* q, const void* k, const void* v,
                             const void* w, void* o, int rows, int t, int c,
                             int band, void* st) {
  return aero::local_attention_fwd_mma(q, k, v, static_cast<const float*>(w),
                                       o, nullptr, rows, t, c, band,
                                       static_cast<cudaStream_t>(st));
}
"""

# csrc/ftb_mma.cu: time tile and blocks per (b, f), which the source picks
# by k-steps KS (enc0-1: 3, enc2: 6, enc3: 12), and ring depth
_TIME = "constexpr int kTime = KS > 4 && KS <= 8 ? 64 : 32;"
_SPLIT = "constexpr int kSplit = KS <= 4 ? 16 : 1;"
FTB_SHAPES = {
    "time_64": (_TIME, "constexpr int kTime = KS <= 8 ? 64 : 32;"),
    "time_32": (_TIME, "constexpr int kTime = 32;"),
    "time_16_enc0": (_TIME, "constexpr int kTime = KS > 4 && KS <= 8 ? 64 : "
                            "(KS <= 4 ? 16 : 32);"),
    "stages_3": ("constexpr int kStages = 2;", "constexpr int kStages = 3;"),
    "split_8": (_SPLIT, "constexpr int kSplit = KS <= 4 ? 8 : 1;"),
    "split_4_wide": (_SPLIT, "constexpr int kSplit = KS <= 4 ? 16 : 4;"),
}
FTB_ENTRY = """
extern "C" int variant_entry(const void* x, const void* y, const void* ht,
                             const void* w, const void* b2, void* out, int b,
                             int c, int c_out, int f, int t, void* st) {
  return aero_ftb_tail_mma(x, y, ht, w, b2, out, b, c, c_out, f, t, st);
}
"""

# csrc/local_attention_bwd_mma.cu: block shape and occupancy
_BWD_WARPS = "constexpr int kWarps = 4;"
BWD_SHAPES = {
    "warps_2": (_BWD_WARPS, "constexpr int kWarps = 2;"),
    "warps_8": (_BWD_WARPS, "constexpr int kWarps = 8;"),
    "tile_32": ("constexpr int kTile = 64; ", "constexpr int kTile = 32; "),
}
BWD_ENTRY = """
extern "C" int variant_entry(const void* q, const void* k, const void* v,
                             const void* w, const void* o, const void* g,
                             const void* lse, void* delta, void* dq, void* dk,
                             void* dv, void* dw, int rows, int t, int c,
                             int band, void* st) {
  return aero::local_attention_bwd_mma(
      q, k, v, static_cast<const float*>(w), o, g,
      static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv,
      static_cast<float*>(dw), rows, t, c, band, static_cast<cudaStream_t>(st));
}
"""


def build(source: str, variants: dict, entry: str, argtypes) -> dict:
    """{name: library} of the base source and each variant (one text
    substitution, which must match once), all nvcc runs in parallel."""
    text = (_build.CSRC / source).read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, sub in {"base": None, **variants}.items():
        body = text
        if sub is not None:
            if text.count(sub[0]) != 1:
                raise ValueError(f"{source}: variant {name} does not match")
            body = text.replace(*sub)
        src = OUT / f"{source[:-3]}_{name}.cu"
        src.write_text(body + entry)
        lib = src.with_suffix(".so")
        procs[name] = (src, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
             "-shared", "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (src, path, proc) in procs.items():
        log, _ = proc.communicate()
        src.unlink()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} {name}:\n{log}")
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill stores" in line and
                         not line.strip().startswith("0 bytes stack")})
        if spills:
            print(f"  {source} {name} spills: {'; '.join(spills)}")
        lib = ctypes.CDLL(str(path))
        lib.variant_entry.argtypes = argtypes
        lib.variant_entry.restype = ctypes.c_int
        libs[name] = lib
    return libs


def lstm_variants(smi):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build("lstm_mma.cu", {f"no_{k}": v for k, v in LSTM_PARTS.items()},
                 LSTM_ENTRY, [ptr] * 4 + [i32] * 4 + [ptr])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, hd in (cs.LSTM_ENC2, cs.LSTM_ENC3, (64, 96)):
        tile = lstm.seq_tile(n, hd, sms)
        xp, w, bias = cs.lstm_inputs(n, hd, torch.bfloat16, seed=220)
        wp = lstm.pack_w_hh_mma(w)
        out = torch.empty(cs.LSTM_STEPS, 2 * hd, n, dtype=torch.bfloat16,
                          device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        row = {}
        for name, lib in list(libs.items()) + list(libs.items())[::-1]:
            def call(lib=lib):
                err = lib.variant_entry(xp.data_ptr(), wp.data_ptr(),
                                        bias.data_ptr(), out.data_ptr(),
                                        cs.LSTM_STEPS, hd, n, tile, stream)
                if err:
                    raise RuntimeError(f"variant launch failed: {err}")
            row.setdefault(name, []).append(cs.time_ms(call, (), 10))
        print(f"lstm N={n} H={hd} tile {tile} bf16, ms per launch: "
              + ", ".join(f"{k} {sum(v) / len(v):.3f}"
                          for k, v in row.items()) + f" [{smi}]", flush=True)


def attention_variants(smi):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build("local_attention_mma.cu", ATTN_SHAPES, ATTN_ENTRY,
                 [ptr] * 5 + [i32] * 4 + [ptr])
    for shape in (cs.ENC2, cs.ENC3, cs.TRAIN_ENC2):
        q, k, v, w = cs.attn_inputs(shape, torch.bfloat16, seed=200)
        b, t, h, c = shape
        fold = [attention._fold(x, b, t, h, c) for x in (q, k, v)]
        wf = attention._fold_w(w, b, t, h)
        stream = torch.cuda.current_stream().cuda_stream
        for band in (t, cs.BAND):
            outs, row = {}, {}
            for name, lib in list(libs.items()) + list(libs.items())[::-1]:
                out = outs.setdefault(name, torch.empty_like(fold[0]))

                def call(lib=lib, out=out):
                    err = lib.variant_entry(
                        *(x.data_ptr() for x in fold), wf.data_ptr(),
                        out.data_ptr(), b * h, t, c, band, stream)
                    if err:
                        raise RuntimeError(f"variant launch failed: {err}")
                row.setdefault(name, []).append(cs.time_ms(call, (), 10))
            diff = [n for n, o in outs.items()
                    if (o.float() - outs["base"].float()).abs().max() > 0.03]
            print(f"attention {shape} band {band if band < t else 0} bf16, "
                  "ms per call: " + ", ".join(
                      f"{k} {sum(v) / len(v):.3f}" for k, v in row.items())
                  + f"; off the base output by > 0.03: {diff or 'none'} "
                  f"[{smi}]", flush=True)


def timed(libs, call):
    """{name: mean ms} of ``call(lib, name)`` for each library, timed in
    the order given and back."""
    row = {}
    for name, lib in list(libs.items()) + list(libs.items())[::-1]:
        row.setdefault(name, []).append(
            cs.time_ms(lambda lib=lib, name=name: call(lib, name), (), 10))
    return {k: sum(v) / len(v) for k, v in row.items()}


def ftb_variants(smi):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build("ftb_mma.cu", FTB_SHAPES, FTB_ENTRY,
                 [ptr] * 6 + [i32] * 5 + [ptr])
    stream = torch.cuda.current_stream().cuda_stream
    for shape in cs.FTB_SHAPES:
        b, c, f, t = shape
        x, h, ka, kb, w_freq, b2 = cs.ftb_inputs(shape, torch.bfloat16, 230)
        y = ftb.freq_mix(x, w_freq)
        ht = h.transpose(1, 2).contiguous()
        w = ftb.pack_ftb_mma(ka, kb)
        outs = {n: torch.empty_like(x) for n in libs}

        def call(lib, name):
            err = lib.variant_entry(x.data_ptr(), y.data_ptr(), ht.data_ptr(),
                                    w.data_ptr(), b2.data_ptr(),
                                    outs[name].data_ptr(), b, c, c, f, t,
                                    stream)
            if err:
                raise RuntimeError(f"variant launch failed: {err}")
        row = timed(libs, call)
        scale = outs["base"].float().abs().max()
        diff = [n for n, o in outs.items() if (o.float() - outs["base"].float()
                                               ).abs().max() > cs.FTB_TOL[torch.bfloat16] * scale]
        print(f"ftb {shape} bf16, ms per launch: " + ", ".join(
            f"{k} {v:.3f}" for k, v in row.items())
            + f"; bound {cs.ftb_bound(shape)[0]:.4f}; off the base output "
            f"by > 2^-6 of max: {diff or 'none'} [{smi}]", flush=True)
        del x, y, outs
        torch.cuda.empty_cache()


def backward_variants(smi):
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    libs = build("local_attention_bwd_mma.cu", BWD_SHAPES, BWD_ENTRY,
                 [ptr] * 12 + [i32] * 4 + [ptr])
    stream = torch.cuda.current_stream().cuda_stream
    for shape in (cs.TRAIN_ENC2, cs.TRAIN_ENC3, cs.ENC2):
        q, k, v, w = cs.attn_inputs(shape, torch.bfloat16, seed=200)
        b, t, h, c = shape
        fold = [attention._fold(a, b, t, h, c) for a in (q, k, v)]
        wf = attention._fold_w(w, b, t, h)
        o_f, lse = attention._kernel_fwd(*fold, wf, with_lse=True)
        g_f = torch.randn_like(o_f)
        outs = {n: [torch.empty_like(o_f) for _ in range(3)]
                + [torch.empty_like(wf), torch.empty_like(wf)] for n in libs}

        def call(lib, name):
            dq, dk, dv, dw, delta = outs[name]
            err = lib.variant_entry(
                *(a.data_ptr() for a in fold), wf.data_ptr(), o_f.data_ptr(),
                g_f.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                b * h, t, c, t, stream)
            if err:
                raise RuntimeError(f"variant launch failed: {err}")
        row = timed(libs, call)
        diff = [n for n, o in outs.items()
                if any((a.float() - e.float()).abs().max()
                       > cs.BWD_TOL_BF16 * e.float().abs().max()
                       for a, e in zip(o[:4], outs["base"][:4]))]
        print(f"backward {shape} bf16, ms per call (2 kernels): " + ", ".join(
            f"{k} {v:.3f}" for k, v in row.items())
            + f"; off the base gradients by > 2e-2 of max: {diff or 'none'} "
            f"[{smi}]", flush=True)


def main():
    smi = cs.card()
    runs = {"lstm": lstm_variants, "attention": attention_variants,
            "ftb": ftb_variants, "backward": backward_variants}
    for name in sys.argv[1:] or runs:
        runs[name](smi)


if __name__ == "__main__":
    main()
