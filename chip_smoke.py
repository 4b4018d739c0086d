"""Chip smoke test of the PyTorch port: the STANDARD and DEEP slot decodes
on one card.

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
   end-to-end decode_slots slots/s at batch 256, peak device memory;
7. the dual-output (dB + boxcar) waterfall kernel against its plain
   version on noisy slots at osr 4x4: 12 kHz (batch 8) and 2 kHz (batch
   8); dB max |difference| <= 5e-3, boxcar |difference| <= 1e-4 x the
   cell + 1e-4 x the grid's mean power; its dB grid against the dB-only
   kernel's at 12 kHz <= 5e-3;
8. the OSD elimination kernel against its plain version, bit for bit, on
   bases permuted by random LLRs with forced zero ties: 4099 and 37 rows
   (not multiples of the kernel's 4 candidates per block);
9. the DEEP path at full size: decode_slots on the same 256 slots at osr
   4x4 (K 40, min_score 1, 20 BP iterations, OSD, mf_first, chunk 8,
   bp_chunk 256); every planted payload must decode, the dual-output
   kernel must launch 256 / 8 times and the OSD kernel at least once;
   OSD-accepted rows (against the same decode without OSD) must be > 0;
   the first 4 slots decoded on the CPU must give the same sets;
10. times: the dual-output kernel (batch 8, 12 kHz) and the OSD kernel
   (1024 rows, the OSD pass size) against their plain versions (CUDA
   events, warm, min of 2 x 20 in the order plain, kernel, kernel,
   plain); DEEP decode_slots slots/s at batch 256 over 5 runs; peak
   device memory.

Then one JSON line with the kernels, the nvidia-smi line, and the last
line {"ok": true, "device": {...}}.  Without a CUDA card it exits 1 and
prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
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
# the DEEP decode
DEEP_OSR = (4, 4)
DEEP_CHUNK = 8
DEEP_CANDIDATES = 40
DEEP_MIN_SCORE = 1.0
DEEP_CPU_SLOTS = 4
DEEP_REPS = 5
BOX_RTOL = 1e-4
OSD_SOURCE = "ft8_demodulator_tpu_torch/csrc/osd_eliminate.cu"
MF_REPLACES = "ft8_demodulator_tpu/ops/waterfall_pallas.py:444"
OSD_REPLACES = "ft8_demodulator_tpu/ops/osd.py:212"
OSD_TIMED_ROWS = 1024


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


def _ptxas_report(log: str) -> list[str]:
    """ptxas's registers, shared memory and spills, per kernel name."""
    out = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            name = entry.group(1)
            for short in ("waterfall_kernel", "osd_eliminate_kernel"):
                if short in name:
                    name = short + {"ILb1E": "<true>", "ILb0E": "<false>"}.get(
                        name[name.index(short) + len(short):][:5], "")
            out.append(name + ":")
        elif "registers" in line or "spill" in line or "smem" in line:
            out.append(line.replace("ptxas info    :", "").strip())
    return out


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


def _kernel_vs_plain_ms(kernel, plain, reps: int = 20) -> tuple[float, float]:
    """(kernel ms, plain ms): warm, min of 2 x reps each, in the order
    plain, kernel, kernel, plain."""
    for fn in (kernel, plain):
        fn()
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        times[name].append(_event_ms(kernel if name == "kernel" else plain,
                                     reps))
    return min(times["kernel"]), min(times["plain"])


def _tied_bases(rows: int, seed: int, device):
    """Packed reliability-permuted OSD bases from random LLRs, a fifth of
    them zero (tied)."""
    from ft8_demodulator_tpu_torch.ops import osd

    rng = np.random.default_rng(seed)
    llr = rng.standard_normal((rows, 174)).astype(np.float32)
    llr[rng.random(llr.shape) < 0.2] = 0.0
    llr = torch.as_tensor(llr, device=device)
    order = torch.sort(-llr.abs(), dim=-1, stable=True).indices
    return osd._permute_pack(order, osd.osd_tables(device))


def _deep_phases(dev, smi: str, waves, payloads) -> list[dict]:
    """Phases 7-10: the DEEP decode's kernels and path.  Returns the
    kernels' JSON records."""
    from ft8_demodulator_tpu_torch.demod.decode import decode_slots
    from ft8_demodulator_tpu_torch.ops import osd_cuda as oc
    from ft8_demodulator_tpu_torch.ops import waterfall_cuda as wc
    from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

    mf = wc.block_waterfall_mf_tf_fused_batch
    mf_plain = wc.block_waterfall_mf_tf_fused_batch_plain
    db_errs, box_errs = {}, {}
    for fs in (12000.0, 2000.0):
        p = waterfall_params(fs, *DEEP_OSR)
        ns = int(fs * SLOT_S)
        nf = p.num_frames(ns)
        rng = np.random.default_rng(int(fs) + 4)
        w8 = torch.as_tensor(
            rng.standard_normal((DEEP_CHUNK, ns)).astype(np.float32),
            device=dev)
        db, box = mf(w8, p, nf)
        torch.cuda.synchronize()
        want_db, want_box = mf_plain(w8, p, nf)
        torch.cuda.synchronize()
        rows = nf + 2 * (p.time_osr - 1)
        if db.shape != (DEEP_CHUNK, nf, p.num_freq_bins) \
                or box.shape != (DEEP_CHUNK, rows, p.num_freq_bins) \
                or not bool(torch.isfinite(db).all()) \
                or not bool(torch.isfinite(box).all()):
            raise RuntimeError(f"dual-output kernel at {fs} Hz: malformed "
                               "or not finite")
        db_errs[fs] = float((db - want_db).abs().max())
        # |diff| / (|want| + mean(want)): <= BOX_RTOL is the bound
        box_errs[fs] = float(((box - want_box).abs()
                              / (want_box.abs() + want_box.mean())).max())
        if not db_errs[fs] <= ATOL_DB or not box_errs[fs] <= BOX_RTOL:
            raise RuntimeError(
                f"dual-output kernel vs plain at {fs} Hz: dB {db_errs[fs]} "
                f"(bound {ATOL_DB}), boxcar {box_errs[fs]} (bound "
                f"{BOX_RTOL})")
        if fs == 12000.0:
            single = wc.block_waterfall_tf_fused_batch(w8, p, nf)
            torch.cuda.synchronize()
            db_vs_single = float((db - single).abs().max())
            if not db_vs_single <= ATOL_DB:
                raise RuntimeError(f"dual-output dB vs dB-only kernel: "
                                   f"{db_vs_single} > {ATOL_DB}")
    _phase(7, "dual-output kernel vs plain at osr 4x4, batch "
              f"{DEEP_CHUNK}: dB max |diff| "
              + ", ".join(f"{fs / 1000:g} kHz {e:.3e}"
                          for fs, e in db_errs.items())
              + f" (bound {ATOL_DB}); boxcar max |diff| / (|cell| + mean) "
              + ", ".join(f"{fs / 1000:g} kHz {e:.3e}"
                          for fs, e in box_errs.items())
              + f" (bound {BOX_RTOL}); dB vs the dB-only kernel at 12 kHz "
                f"{db_vs_single:.3e}")

    for rows, seed in ((4099, 1), (37, 2)):
        bases = _tied_bases(rows, seed, dev)
        red, pcol = oc.reduce_basis_batch(bases)
        torch.cuda.synchronize()
        want_red, want_pcol = oc.reduce_basis_batch_plain(bases)
        if not (torch.equal(red, want_red) and torch.equal(pcol, want_pcol)):
            bad = int((red != want_red).any(-1).any(-1).sum()
                      + (pcol != want_pcol).any(-1).sum())
            raise RuntimeError(f"OSD kernel vs plain on {rows} bases: "
                               f"{bad} differ")
    _phase(8, "OSD elimination kernel == plain bit for bit on 4099 and 37 "
              "bases (random LLRs, 20 % zero ties)")

    p = waterfall_params(FS, *DEEP_OSR)
    nf = p.num_frames(waves.shape[1])
    kw = dict(max_candidates=DEEP_CANDIDATES, min_score=DEEP_MIN_SCORE,
              max_iterations=BP_ITERATIONS, mf_first=True, chunk=DEEP_CHUNK,
              bp_chunk=BP_CHUNK)
    torch.cuda.synchronize()
    mf.launches = 0
    oc.reduce_basis_batch.launches = 0
    oc.reduce_basis_batch.rows = 0
    t0 = time.perf_counter()
    res = decode_slots(waves, p, nf, use_osd=True, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    mf_launches = mf.launches
    osd_launches = oc.reduce_basis_batch.launches
    osd_rows = oc.reduce_basis_batch.rows
    if mf_launches != BATCH // DEEP_CHUNK:
        raise RuntimeError(f"dual-output kernel launched {mf_launches} "
                           f"times, want {BATCH // DEEP_CHUNK}")
    if osd_launches < 1:
        raise RuntimeError("the OSD kernel was not launched")
    if res.success.shape != (BATCH, DEEP_CANDIDATES) \
            or res.payload.shape != (BATCH, DEEP_CANDIDATES, 10) \
            or not bool(torch.isfinite(res.score[res.candidate_valid]).all()):
        raise RuntimeError("DEEP decode_slots result is malformed")
    sets = _decode_sets(res, BATCH)
    decoded = sum(bytes(payloads[b]) in {s[0] for s in sets[b]}
                  for b in range(BATCH))
    if decoded != BATCH:
        raise RuntimeError(f"DEEP yield {decoded}/{BATCH}")
    unplanted = sum(s[0] != bytes(payloads[b])
                    for b in range(BATCH) for s in sets[b])
    bp_only = decode_slots(waves, p, nf, use_osd=False, **kw)
    if bool((bp_only.success & ~res.success).any()):
        raise RuntimeError("a BP decode was lost with OSD on")
    osd_accepted = int((res.success & ~bp_only.success).sum())
    if osd_accepted < 1:
        raise RuntimeError("OSD accepted no row on the 0-dB slots")
    _phase(9, f"DEEP decode_slots {BATCH} slots at {FS / 1000:g} kHz osr "
              f"{DEEP_OSR[0]}x{DEEP_OSR[1]}: yield {decoded}/{BATCH}, "
              f"dual-output kernel launches {mf_launches}, OSD kernel "
              f"launches {osd_launches} reducing {osd_rows} rows, "
              f"{int(res.success.sum())} successful rows of which "
              f"{osd_accepted} OSD-accepted, {unplanted} unplanted decodes, "
              f"first call {first_s:.2f} s")

    host = decode_slots(waves[:DEEP_CPU_SLOTS].cpu(), p, nf, use_osd=True,
                        **dict(kw, chunk=DEEP_CPU_SLOTS))
    host_sets = _decode_sets(host, DEEP_CPU_SLOTS)
    for b in range(DEEP_CPU_SLOTS):
        if host_sets[b] != sets[b]:
            raise RuntimeError(f"DEEP slot {b}: card decodes "
                               f"{sorted(sets[b])}, CPU decodes "
                               f"{sorted(host_sets[b])}")
    _phase(9, f"DEEP card == CPU decode sets on the first {DEEP_CPU_SLOTS} "
              f"slots ({sum(map(len, host_sets))} decodes)")

    w8 = waves[:DEEP_CHUNK].contiguous()
    consts = wc.fused_constants(p, dev)
    mf_ms, mf_plain_ms = _kernel_vs_plain_ms(
        lambda: mf(w8, p, nf, consts), lambda: mf_plain(w8, p, nf, consts))
    kx = p.num_freq_bins + 2 * p.freq_osr
    dft_flop = 4 * (nf + p.time_osr - 1) * p.hop * kx * DEEP_CHUNK
    bases = _tied_bases(OSD_TIMED_ROWS, 3, dev)
    osd_ms, osd_plain_ms = _kernel_vs_plain_ms(
        lambda: oc.reduce_basis_batch(bases),
        lambda: oc.reduce_basis_batch_plain(bases))

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    runs = []
    for _ in range(DEEP_REPS):
        t0 = time.perf_counter()
        decode_slots(waves, p, nf, use_osd=True, **kw)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    rates = sorted(BATCH / r for r in runs)
    _phase(10, f"[{smi}] dual-output kernel batch {DEEP_CHUNK} at "
               f"{FS / 1000:g} kHz osr 4x4: kernel {mf_ms:.4f} ms "
               f"({dft_flop / (mf_ms * 1e-3) / 1e12:.1f} TFLOP/s of DFT), "
               f"plain {mf_plain_ms:.4f} ms; OSD kernel {OSD_TIMED_ROWS} "
               f"rows: kernel {osd_ms * 1e3:.1f} us, plain "
               f"{osd_plain_ms * 1e3:.1f} us (min of 2 x 20 warm); DEEP "
               f"decode_slots batch {BATCH}: slots/s over {DEEP_REPS} runs "
               f"min {rates[0]:.1f}, median {rates[len(rates) // 2]:.1f}, "
               f"max {rates[-1]:.1f}; peak memory {peak_mib:.1f} MiB")
    return [
        {"name": "waterfall_mf_tf", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": MF_REPLACES,
         "launches": mf_launches,
         "max_abs_err": max(db_errs.values()), "ms": mf_ms,
         "plain_ms": mf_plain_ms},
        {"name": "osd_eliminate", "route": "cuda", "source": OSD_SOURCE,
         "replaces": OSD_REPLACES, "launches": osd_launches,
         "max_abs_err": 0.0, "ms": osd_ms, "plain_ms": osd_plain_ms},
    ]


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
    _phase(2, f"built {kl.path.name} in {time.perf_counter() - t0:.1f} s; "
              + " | ".join(_ptxas_report(kl.log)))

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
    reps = 20
    kernel_ms, plain_ms = _kernel_vs_plain_ms(
        lambda: wc.block_waterfall_tf_fused_batch(b16, p, nf, consts),
        lambda: wc.block_waterfall_tf_fused_batch_plain(b16, p, nf, consts),
        reps)
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

    deep_kernels = _deep_phases(dev, smi, waves, payloads)

    print(json.dumps({"kernels": [{
        "name": "waterfall_tf", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(errs.values()), "ms": kernel_ms,
        "plain_ms": plain_ms}] + deep_kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
