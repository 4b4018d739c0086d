"""Chip smoke test of the PyTorch port: the STANDARD slot decode on one card.

    python3 chip_smoke.py

Phases, one line each (any failure raises, and the script exits non-zero):

1. the card: name, count, and nvidia-smi's name and power limit;
2. build the CUDA kernels from ft8_demodulator_tpu_torch/csrc (nvcc,
   sm_90a) and print ptxas's registers, shared memory and spills;
3. the fused waterfall kernel against its plain PyTorch version on noisy
   slots: 12 kHz osr 2x2 (batch 16) and 20 kHz osr 2x2 (batch 4),
   max |difference| <= 5e-3 dB;
4. the main path at full size: decode_slots on 256 synthetic 0-dB slots at
   12 kHz (K 20, min_score 10, 20 BP iterations, chunk 16, bp_chunk 256);
   every planted payload must decode, and the kernel's launch counter must
   show that the front half went through it (256 / 16 launches);
5. the first 8 of those slots decoded on the CPU (plain waterfall) as well:
   the same payloads at the same (abs_time, abs_freq) on both;
6. times: the kernel and its plain version (CUDA events, warm, batch 16),
   end-to-end decode_slots slots/s at batch 256, peak device memory.

Then one JSON line with the kernels, the nvidia-smi line, and the last
line {"ok": true, "device": {...}}.  Without a CUDA card it exits 1 and
prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

FS = 12000.0
SLOT_S = 15.0
BATCH = 256
CHUNK = 16
BP_CHUNK = 256
MAX_CANDIDATES = 20
MIN_SCORE = 10.0
BP_ITERATIONS = 20
CPU_SLOTS = 8
ATOL_DB = 5e-3
KERNEL_SOURCE = "ft8_demodulator_tpu_torch/csrc/waterfall_tf.cu"
REPLACES = "ft8_demodulator_tpu/ops/waterfall_pallas.py:123"


def _phase(n: int, text: str) -> None:
    print(f"[{n}] {text}", flush=True)


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _synth_slots(device):
    """BATCH noisy 12 kHz slots, each holding one FT8 signal at 0 dB, from
    numpy.random.default_rng(42) (bench.py's recipe)."""
    from ft8_demodulator_tpu_torch.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu_torch.protocol import constants as C
    from ft8_demodulator_tpu_torch.protocol.encode import encode_tones

    rng = np.random.default_rng(42)
    n = int(FS * SLOT_S)
    sps = int(C.SYMBOL_PERIOD_S * FS)
    payloads = rng.integers(0, 256, size=(BATCH, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    noise = torch.as_tensor(
        rng.standard_normal((BATCH, n)).astype(np.float32), device=device)
    f0s = (500.0 + 100.0 * rng.integers(0, 40, BATCH)).astype(np.float32)

    tones = encode_tones(torch.as_tensor(payloads, device=device))
    sig = torch.zeros((BATCH, n), dtype=torch.float32, device=device)
    for i in range(BATCH):
        wave = _baseband_complex(tones[i], sps, FS, float(f0s[i])).real
        sig[i, : wave.shape[0]] = wave
        power = torch.mean(wave ** 2)
        sig[i] += noise[i] * torch.sqrt(power)
    return sig, payloads


def _decode_sets(res, slots):
    """Per slot: {(payload bytes, abs_time, abs_freq)} of its successes."""
    ok = res.success.cpu().numpy()
    pl = res.payload.cpu().numpy()
    t = res.abs_time.cpu().numpy()
    f = res.abs_freq.cpu().numpy()
    return [{(bytes(pl[b, k]), int(t[b, k]), int(f[b, k]))
             for k in np.flatnonzero(ok[b])} for b in range(slots)]


def _event_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1

    from ft8_demodulator_tpu_torch.demod.decode import decode_slots
    from ft8_demodulator_tpu_torch.ops import waterfall_cuda as wc
    from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu_torch.utils.build import kernel_library

    # plain versions compute in float32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = _nvidia_smi()
    _phase(1, f"device {kind!r}, count {count}, nvidia-smi: {smi}; "
              f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    kl = kernel_library()
    ptxas = [ln.strip() for ln in kl.log.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    _phase(2, f"built {kl.path.name} in {time.perf_counter() - t0:.1f} s; "
              + " | ".join(ptxas))

    n = int(FS * SLOT_S)
    errs = {}
    for fs, b in ((12000.0, 16), (20000.0, 4)):
        p = waterfall_params(fs, 2, 2)
        ns = int(fs * SLOT_S)
        nf = p.num_frames(ns)
        rng = np.random.default_rng(int(fs))
        waves = torch.as_tensor(
            rng.standard_normal((b, ns)).astype(np.float32), device=dev)
        got = wc.block_waterfall_tf_fused_batch(waves, p, nf)
        torch.cuda.synchronize()
        want = wc.block_waterfall_tf_fused_batch_plain(waves, p, nf)
        torch.cuda.synchronize()
        if got.shape != (b, nf, p.num_freq_bins) \
                or not bool(torch.isfinite(got).all()):
            raise RuntimeError(f"kernel output {tuple(got.shape)} at {fs} Hz"
                               " is malformed or not finite")
        errs[fs] = float((got - want).abs().max())
        if not errs[fs] <= ATOL_DB:
            raise RuntimeError(f"kernel vs plain at {fs} Hz: max |diff| "
                               f"{errs[fs]} dB > {ATOL_DB}")
    _phase(3, "kernel vs plain, max |diff| dB: "
              + ", ".join(f"{fs / 1000:g} kHz osr 2x2 {e:.3e}"
                          for fs, e in errs.items())
              + f" (bound {ATOL_DB})")

    p = waterfall_params(FS, 2, 2)
    nf = p.num_frames(n)
    waves, payloads = _synth_slots(dev)
    kw = dict(max_candidates=MAX_CANDIDATES, min_score=MIN_SCORE,
              max_iterations=BP_ITERATIONS)
    torch.cuda.synchronize()
    wc.block_waterfall_tf_fused_batch.launches = 0
    t0 = time.perf_counter()
    res = decode_slots(waves, p, nf, chunk=CHUNK, bp_chunk=BP_CHUNK, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = wc.block_waterfall_tf_fused_batch.launches
    if launches != BATCH // CHUNK:
        raise RuntimeError(f"waterfall kernel launched {launches} times, "
                           f"want {BATCH // CHUNK}")
    if res.success.shape != (BATCH, MAX_CANDIDATES) \
            or res.payload.shape != (BATCH, MAX_CANDIDATES, 10) \
            or not bool(torch.isfinite(res.score[res.candidate_valid]).all()):
        raise RuntimeError("decode_slots result is malformed")
    sets = _decode_sets(res, BATCH)
    decoded = sum(bytes(payloads[b]) in {s[0] for s in sets[b]}
                  for b in range(BATCH))
    if decoded != BATCH:
        raise RuntimeError(f"yield {decoded}/{BATCH}: planted payloads lost")
    _phase(4, f"decode_slots {BATCH} slots at {FS / 1000:g} kHz: yield "
              f"{decoded}/{BATCH}, waterfall kernel launches {launches}, "
              f"{int(res.success.sum())} successful rows, first call "
              f"{first_s:.2f} s")

    host = decode_slots(waves[:CPU_SLOTS].cpu(), p, nf, chunk=CPU_SLOTS,
                        bp_chunk=BP_CHUNK, **kw)
    host_sets = _decode_sets(host, CPU_SLOTS)
    for b in range(CPU_SLOTS):
        if host_sets[b] != sets[b]:
            raise RuntimeError(f"slot {b}: card decodes {sorted(sets[b])}, "
                               f"CPU decodes {sorted(host_sets[b])}")
    _phase(5, f"card == CPU decode sets on the first {CPU_SLOTS} slots "
              f"({sum(map(len, host_sets))} decodes)")

    b16 = waves[:CHUNK].contiguous()
    consts = wc.fused_constants(p, dev)
    kernel = lambda: wc.block_waterfall_tf_fused_batch(b16, p, nf, consts)
    plain = lambda: wc.block_waterfall_tf_fused_batch_plain(b16, p, nf,
                                                            consts)
    for fn in (kernel, plain):
        fn()
    reps = 20
    # plain, kernel, kernel, plain
    order = [("plain", plain), ("kernel", kernel), ("kernel", kernel),
             ("plain", plain)]
    times = {"plain": [], "kernel": []}
    for name, fn in order:
        times[name].append(_event_ms(fn, reps))
    kernel_ms = min(times["kernel"])
    plain_ms = min(times["plain"])
    # the DFT's multiply-adds (cos and sin), halo recompute not counted
    kx = p.num_freq_bins + 2 * p.freq_osr
    dft_flop = 4 * (nf + p.time_osr - 1) * p.hop * kx * CHUNK
    tflops = dft_flop / (kernel_ms * 1e-3) / 1e12

    torch.cuda.reset_peak_memory_stats()
    reps_e2e = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps_e2e):
        res = decode_slots(waves, p, nf, chunk=CHUNK, bp_chunk=BP_CHUNK,
                           **kw)
    torch.cuda.synchronize()
    e2e_s = (time.perf_counter() - t0) / reps_e2e
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    _phase(6, f"[{smi}] waterfall batch {CHUNK} at {FS / 1000:g} kHz: "
              f"kernel {kernel_ms:.4f} ms ({tflops:.1f} TFLOP/s of DFT), "
              f"plain {plain_ms:.4f} ms "
              f"(min of 2 x {reps} warm launches each); decode_slots "
              f"batch {BATCH}: {BATCH / e2e_s:.1f} slots/s "
              f"({e2e_s * 1e3:.1f} ms per batch, mean of {reps_e2e}); "
              f"peak memory {peak_mib:.1f} MiB")

    print(json.dumps({"kernels": [{
        "name": "waterfall_tf", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(errs.values()), "ms": kernel_ms,
        "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
