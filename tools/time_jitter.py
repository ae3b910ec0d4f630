#!/usr/bin/env python3
"""Time several ColorJitter kernel sources against each other by one clock.

    python3 tools/time_jitter.py NAME=SOURCE[:two_pass][:timing_only][:-DMACRO=VALUE ...] ...

Each source (a ``color_jitter`` entry with a plain C interface: the
one-pass one of ``sfmnext_tpu_torch/csrc/jitter_kernel.cu``, or with
``two_pass`` the two-pass one of ``tools/jitter_two_pass.cu``) is built
alone with nvcc into its own library under ``sfmnext_tpu_torch/_build/``,
all builds in parallel, with the given macros. On the flagship stack
(``chip_smoke.py``'s: [8,3,320,1024,3], contrast first in sample 0 and last
in sample 1, 6 of 8 samples jittered) each is held against
``plain_color_jitter`` (1e-5), called twice for the same bits and checked
to copy the skipped samples bit for bit (printed, not required, for a
``timing_only`` copy with a part taken out); then all are timed in turns
(first to last, last to first, ``ROUNDS`` times; ``chip_smoke.device_times``
a turn) and the median device time of each is printed with the bound.
Needs a CUDA card; run from the repository's root.
"""

import ctypes
import statistics
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from sfmnext_tpu_torch.data import augment  # noqa: E402
from sfmnext_tpu_torch.device import cuda_device  # noqa: E402
from sfmnext_tpu_torch.ops import _build, jitter_kernel  # noqa: E402

ROUNDS = 3


def main(specs) -> int:
    if not torch.cuda.is_available():
        print("time_jitter: no CUDA device visible", file=sys.stderr)
        return 1
    dev = cuda_device()
    variants = {}
    for spec in specs:
        name, rest = spec.split("=", 1)
        source, *flags = rest.split(":")
        defines = [f for f in flags if f.startswith("-D")]
        build = cs.start_alone_build(ROOT / source, _build.BUILD_DIR / f"libjitter_{name}.so",
                                     defines)
        variants[name] = (build, "two_pass" in flags, "timing_only" in flags)
    libs = {name: cs.finish_alone_build(*build, name) for name, (build, _, _) in variants.items()}
    fns = {name: cs.jitter_entry(libs[name], variants[name][1]) for name in variants}

    b, frames, (hh, ww) = cs.B_TRAIN, 3, cs.HW_TRAIN
    color = torch.from_numpy(cs.synthetic_images(b * frames, hh, ww, seed=ww)).to(dev)
    color = color.reshape(b, frames, hh, ww, 3)
    order, factors, _ = augment.jitter_params(torch.Generator(device=dev).manual_seed(b), b)
    order[0] = torch.tensor([1, 0, 2, 3], device=dev, dtype=torch.int32)
    order[1] = torch.tensor([3, 2, 0, 1], device=dev, dtype=torch.int32)
    do_jit = torch.arange(b, device=dev) % 3 != 2
    want = jitter_kernel.plain_color_jitter(color, order, factors, do_jit)
    for name, lib in libs.items():
        if hasattr(lib, "color_jitter_grid"):
            got = [ctypes.c_int() for _ in range(3)]
            err = lib.color_jitter_grid(hh, ww, *[ctypes.byref(x) for x in got])
            print(f"[variant] {name} grid (error {err}): {got[0].value} clusters, "
                  f"{got[1].value} of {got[2].value} chunks of a block's span kept", flush=True)
    for name, fn in fns.items():
        first, second = fn(color, order, factors, do_jit), fn(color, order, factors, do_jit)
        torch.cuda.synchronize()
        err, ok = cs.compare(first, want, 0.0, cs.JITTER_TOL)
        same = torch.equal(first, second)
        copied = torch.equal(first[~do_jit], color[~do_jit])
        print(f"[variant] {name}: max_abs_err {err:.4e} (atol {cs.JITTER_TOL}), repeats bit for "
              f"bit: {same}, skipped samples copied: {copied}", flush=True)
        cs.require(variants[name][2] or (ok and same and copied), f"{name} is wrong")

    n_px = b * frames * hh * ww
    bms, by = cs.bound_ms(2 * 4 * n_px * 3 + 4 * b * 9,
                          cs.JITTER_OPS * int(do_jit.sum()) * frames * hh * ww, cs.F32_FLOPS)
    times = {name: [] for name in fns}
    names = list(fns)
    for _ in range(ROUNDS):
        for name in names + names[::-1]:
            times[name] += cs.device_times(lambda: fns[name](color, order, factors, do_jit))
    for name in names:
        ms = statistics.median(times[name])
        print(f"[variant] {name}: median {ms:.4f} ms over {len(times[name])} calls "
              f"(min {min(times[name]):.4f}), {bms / ms:.2f} of the bound {bms:.4f} ms ({by})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
