"""The Gram backward's kernels on the card: the L2 read rate that bounds
their products, and each kernel's device time and its outputs' bits.

    python -m gaussian_processes_tpu_torch.benchmarks.gram_backward \\
        [--sections l2,kernels]

Sections, each printing one JSON line:

- ``l2``: the rate at which the SMs read an L2-resident buffer (8-32 MB) and
  a 1 GB one, with ``ld.global.cg`` and with TMA bulk copies
  (``l2_probe.cu``), in TB/s;
- ``kernels``: at each of ``SHAPES`` (the M-step's Grams, the population's
  batched Grams, small Grams of the loop and the tests), on ``operands``
  (seeded), the forward's q12 and a seeded g: the device ms a backward of
  each kernel of ``gram_cuda.gram_backward`` by name under torch.profiler
  (10 backwards), the whole backward's ms by CUDA events (one call), the FP32
  ``torch.matmul`` of each product, the bounds, and ``digests`` of the
  outputs (du1, ds2, dq11, dq22, dsigma0).

The ``kernels`` section calls only ``gram_cuda._forward(...,
keep_q12=True)`` and ``gram_cuda.gram_backward``, which every build has had
since the backward came to the card (commit c51b73d).  So two builds are
compared by copying this file and ``l2_probe.cu`` into the other checkout's
``benchmarks/`` and running both there and here in turns, in one call to
the card: equal digests are equal bits.  Card only.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import cuda_build
from ..ops import gram_cuda as G

_PTR, _I32 = ctypes.c_void_p, ctypes.c_int
L2_PROBE = Path(__file__).resolve().parent / "l2_probe.cu"
TF32_FLOPS, HBM_BYTES = 495e12, 3.35e12

# (batch or None, m, n, k): the M-step's K_tilde and K at the 80- and 96-px
# crops, the population's batched Grams, small Grams where the products
# met the FP32 matmul, and a split-k and a batched shape of the card tests
SHAPES = ((None, 2100, 2100, 6400), (None, 3160, 2100, 6400),
          (None, 2100, 2100, 9216), (None, 3160, 2100, 9216),
          (30, 512, 512, 11664), (30, 3160, 512, 11664),
          (None, 300, 300, 6400), (None, 512, 512, 6400),
          (None, 256, 64, 576), (None, 37, 301, 1002), (3, 131, 67, 258))
CALLS = 10  # backwards traced at each shape


def operands(device, batch, m, n, k):
    """Seeded (seed m + n + k, on the CPU) u1 ((B,) m, k), s2 ((B,) n, k),
    their rows' squared norms, sigma0 (0.7, or one in [0.3, 1.3) an item),
    and g ((B,) m, n, seed k), on ``device``."""
    gen = torch.Generator().manual_seed(m + n + k)
    lead = (batch,) if batch else ()
    u1 = torch.randn(*lead, m, k, generator=gen).to(device)
    s2 = torch.randn(*lead, n, k, generator=gen).to(device)
    s0 = ((0.3 + torch.rand(batch, generator=gen)) if batch
          else torch.tensor(0.7)).to(device)
    g = torch.randn(*lead, m, n,
                    generator=torch.Generator().manual_seed(k)).to(device)
    return (u1, s2, (u1 * u1).sum(-1), (s2 * s2).sum(-1), s0), g


def digests(outputs) -> list:
    """The first 16 hex digits of the sha256 of each tensor's bytes."""
    return [hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]
            for t in outputs]


def events_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median ms of one fn() between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


# ---------------------------------------------------------------------------
# Sections
# ---------------------------------------------------------------------------

def section_l2(device) -> dict:
    """TB/s of ld.global.cg and of TMA bulk copies over buffers of 8, 16,
    32 and 1024 MB (each read 256 MB in all, or once)."""
    lib, _, _ = cuda_build.build(str(L2_PROBE))
    lib.l2_read.argtypes = [_PTR, ctypes.c_size_t, _I32, _I32, _I32, _PTR,
                            _PTR]
    lib.l2_bulk.argtypes = [_PTR, ctypes.c_size_t, _I32, _I32, _I32, _I32,
                            _PTR]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    sink = torch.empty(1, device=device)
    out = {}
    for mb in (8, 16, 32, 1024):
        buf = torch.ones(mb * 2 ** 20 // 4, device=device)
        nbytes = buf.numel() * 4
        passes = max(1, 256 // mb)
        runs = {
            "ld.global.cg": lambda: lib.l2_read(
                buf.data_ptr(), nbytes, passes, 8 * sms, 256,
                sink.data_ptr(), _stream()),
            "bulk 16 KB x 8": lambda: lib.l2_bulk(
                buf.data_ptr(), nbytes, 16384, 8, passes, sms, _stream()),
            "bulk 64 KB x 3": lambda: lib.l2_bulk(
                buf.data_ptr(), nbytes, 65536, 3, passes, sms, _stream()),
        }
        for name, fn in runs.items():
            rc = fn()
            if rc != 0:
                raise RuntimeError(f"l2_probe {name}: error {rc}")
            ms = events_ms(fn)
            out[f"{name}, {mb} MB"] = nbytes * passes / ms / 1e9
        del buf
    return out


def _kernel_name(name: str) -> str:
    name = name.replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("<")[0].split()[-1]


def section_kernels(device) -> dict:
    """Each kernel's device ms a backward (torch.profiler over ``CALLS``
    backwards; a kernel launched more than once a backward also each
    launch's, in launch order: the products dS2 then dU1), the whole
    backward's ms (CUDA events, one call), the FP32 matmuls of dU1 and
    dS2, the bounds (the epilogue's function: 12 bytes an element; a
    product: 6 m n k TF32 flops) and the outputs' digests, at each
    shape."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for batch, m, n, k in SHAPES:
        ops, g = operands(device, batch, m, n, k)
        u1, s2, q11, q22, s0 = ops
        with torch.no_grad():
            _, q12 = G._forward(*ops, keep_q12=True)

        def backward():
            return G.gram_backward(g, u1, s2, q11, q22, s0, q12)

        got = backward()
        again = backward()
        torch.cuda.synchronize()
        repeat = all(torch.equal(a, b) for a, b in zip(got, again))
        del again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                backward()
            torch.cuda.synchronize()
        runs = {}
        for e in sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start):
            runs.setdefault(_kernel_name(e.name), []).append(
                e.time_range.elapsed_us() / 1e3)
        # a kernel's ms a backward: the mean of the launches the trace
        # holds (at small shapes it can miss a few) times its launches a
        # backward; where the trace holds every launch, also each launch's
        # own (in the order of a backward's launches)
        per = {name: max(1, round(len(t) / CALLS))
               for name, t in runs.items()}
        each = {name: [sum(t[j::per[name]]) / CALLS
                       for j in range(per[name])]
                for name, t in runs.items()
                if per[name] > 1 and len(t) == per[name] * CALLS}
        dq12 = torch.randn_like(g)
        items = batch or 1
        key = f"{f'{batch} x ' if batch else ''}{m}x{n} k {k}"
        out[key] = {
            "kernels_ms": {name: sum(t) / len(t) * per[name]
                           for name, t in sorted(runs.items())},
            "launches": per,
            "launches_traced": {name: len(t) for name, t in runs.items()},
            "each_launch_ms": each,
            "backward_ms": events_ms(backward),
            "du1_matmul_ms": events_ms(lambda: torch.matmul(dq12, s2)),
            "ds2_matmul_ms": events_ms(lambda: torch.matmul(dq12.mT, u1)),
            "epilogue_bound_ms": 4 * items * (3 * m * n + 2 * (m + n) + 2)
            / HBM_BYTES * 1e3,
            "du1_bound_ms": 6 * items * m * n * k / TF32_FLOPS * 1e3,
            "ds2_bound_ms": 6 * items * m * n * k / TF32_FLOPS * 1e3,
            "digests": dict(zip(("du1", "ds2", "dq11", "dq22", "dsigma0"),
                                digests(got))),
            "two_runs_bit_for_bit": repeat,
        }
        print(json.dumps({key: out[key]}), flush=True)
        del ops, g, u1, s2, q11, q22, s0, q12, got, dq12
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sections", default="l2,kernels")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gram_backward: needs a CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    G.load_library()
    sections = {"l2": lambda: section_l2(device),
                "kernels": lambda: section_kernels(device)}
    record = {"device": smi, "build_s": G.build_seconds}
    for section in args.sections.split(","):
        if section not in sections:
            raise SystemExit(f"unknown section {section!r}")
        record[section] = sections[section]()
        print(json.dumps({section: record[section], "device": smi}),
              flush=True)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
