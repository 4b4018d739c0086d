"""Chip smoke test of the PyTorch port: the STANDARD and DEEP slot decodes,
the host decode API, the beacon receiver, the satellite channel, the
streaming session, the command line, the parallel decodes and the reference
soak's random draws on one card.

    python3 chip_smoke.py

Phases, one line each (any failure raises, and the script exits non-zero):

1. the card: name, count, and nvidia-smi's name and power limit;
2. build the CUDA kernels from ft8_demodulator_tpu_torch/csrc (nvcc,
   sm_90a); count in cuobjdump -sass the HGMMA (wgmma) and UTMALDG (TMA
   load) instructions of both fused waterfall instances and the LDGSTS
   (cp.async) and LDS (shared-memory load) instructions of every sync
   stencil instance (0 raises, as does a sync_kernel spill); print
   ptxas's registers, shared memory and spills;
3. the fused waterfall kernel against its plain PyTorch version on noisy
   slots: 12 kHz osr 2x2 (batch 16), 20 kHz osr 2x2 (batch 4) and 11,025
   Hz osr 2x2 (batch 4, a hop of 882, not a multiple of 8),
   max |difference| <= 5e-3 dB where the plain grid is above -100 dB and
   <= 5e-2 dB below (see NULL_DB), both against a float64 reference too;
4. the main path at full size: decode_slots on 256 synthetic 0-dB slots at
   12 kHz (K 20, min_score 10, 20 BP iterations, chunk 16, bp_chunk 256);
   every planted payload must decode, and the launch counters must show
   that the front half went through the waterfall and sync kernels (256 /
   16 launches each);
5. the first 8 of those slots decoded on the CPU (plain waterfall) as well:
   the same payloads at the same (abs_time, abs_freq) on both;
6. decode_slots on 4 synthetic 0-dB slots at 20 kHz (K2's geometry,
   chunk 4): yield 4/4 and one waterfall launch; times: the kernel (its
   pre-pass included), its plain version and the library yardstick
   (torch.stft + dB, first held to the float32 plain waterfall) at 12 kHz
   batch 16 and 20 kHz batch 4 (device time from torch.profiler kernel
   intervals, warm; a plain window counts only when it holds every device
   event of its calls, a hand kernel's the calls whose every launch has
   its device record, when at most 2 of 20 lack one), beside each
   kernel's bound; end-to-end decode_slots
   slots/s at batch 256, peak device memory;
7. the dual-output (dB + boxcar) waterfall kernel against its plain
   version on noisy slots at osr 4x4: 12 kHz (batch 8) and 2 kHz (batch
   8); dB max |difference| as in phase 3, boxcar |difference| <= 1e-4 x the
   cell + 1e-4 x the grid's mean power; its dB grid against the dB-only
   kernel's at 12 kHz <= 5e-3; the yardstick (a Hann and a rectangular
   torch.stft) against the float32 plain grids;
8. the OSD kernel K4: its elimination entry (reliability order ->
   permuted, packed and reduced bases, one launch) against its plain
   version (the permute-pack, then the elimination), bit for bit, on the
   orders of random LLRs with forced zero ties: 4099 and 37 rows (not
   multiples of the entry's 4 candidates per block); the whole OSD (LLRs
   and a need mask -> codewords and accept flags, one launch) against the
   CPU route (ops/osd.py: torch.sort, the plain elimination, _osd_tail)
   and the numpy model (tests/_torch_k4_model.py) on 2,000 cliff rows, 40
   % needed, with tied magnitudes and zeros of both signs: equal to the
   CPU route on every row but the near ties the model names (a gap within
   1e-5 that is not zero; counted), to the model bit for bit; ptxas's
   report of the fused kernel (a spill raises);
9. the DEEP path at full size: decode_slots on the same 256 slots at osr
   4x4 (K 40, min_score 1, 20 BP iterations, OSD, mf_first, chunk 8,
   bp_chunk 256); every planted payload must decode, the dual-output and
   sync kernels must launch 256 / 8 times each and the OSD kernel exactly
   once (one BP group), over exactly the rows BP left (the valid
   candidates that the same decode without OSD does not decode);
   OSD-accepted rows must be > 0 and no BP decode lost; the OSD kernel
   equals the CPU route on that call's rows (its LLRs and need mask taken
   from a second, uncounted call), near ties as in phase 8, and the model
   bit for bit; the kernels line's osd record gives the differing rows'
   largest |plain difference| and how many near-tie rows differ; the
   first 4 slots decoded on the CPU must give the same sets;
10. times: the dual-output kernel (batch 8, 12 kHz; and its yardstick)
   against its plain version and bound (device time, as in phase 6); the
   OSD kernel at the DEEP call's rows (its one launch per batch), at
   deep.weak's (3,620 needed of 10,240) and at deepest.qso's five sizes
   (40, 80, 240, 1,400 and 1,678 rows), against its bound, the route it
   replaced on the card (torch.sort, the elimination entry, _osd_tail) and
   the plain route (device time), and each call's wall time back to back
   beside that route's (its nonzero, compaction and scatter included);
   one row's chain at 40 rows split: the kernel at order2 0 and the
   elimination entry alone; DEEP decode_slots slots/s at batch 256 over 5 runs; peak device
   memory;
11. the sync stencil kernels against their plain versions, bit for bit
   (torch.equal, identical -inf masks; anything else raises): time-major
   on dB grids at 12 kHz osr 2x2 (batch 16) and 4x4 (batch 8) and 2 kHz
   2x2 (batch 3); frequency-major at 12 kHz 2x2 and 4x4 and on
   a cropped (strided) view; both ways at 12 kHz time_osr 3, freq_osr 1
   (batch 2) and osr 10x10 (batch 2, plain waterfall; the generic
   instance on a shrunk tile); an osr that fits no tile raises the
   wrapper's ValueError, as does the waterfall kernel at time_osr 10;
   ptxas's registers, shared memory and spills;
12. the host API decode_ft8_message on one crowded 15-s 12 kHz capture
   (15 signals at -12..+5 dB, 300-2800 Hz, >= 60 Hz apart, plus one 13 dB
   under the strongest, 30 Hz above it and a symbol later): STANDARD, DEEP
   (the CLI's --deep preset), mf_first and passes=2; each run decodes every
   planted payload above its stated SNR and nothing unplanted, gives the
   rows the CPU gives (payloads, times, frequencies; score within 1e-4,
   SNR within 0.1), launches the frequency-major sync kernel (and the OSD
   kernel under OSD); the buried signal decodes only in the second pass;
   the deep retries on top of DEEP (mf_refine, mf_first + mf_refine,
   coherent, ap with two calls, coherent + ap) also decode every payload
   DEEP decodes; then osr 10x10 (bins_per_tone = steps_per_symbol = 10) on
   a band crop around the strongest signal: it decodes, with the CPU's
   rows; then a second capture of six weak off-grid CQ transmissions
   (-22..-19 dB, packed by the port's message codec): DEEP, coherent, ap
   and coherent + ap give the CPU's rows, nothing unplanted, and some
   retry decodes a payload DEEP misses (printed); on the same capture as
   one slot, decode_slot with use_mf + mf_refine, mf_first + mf_refine and
   mf_first + coherent (osr 4x4, OSD) gives the CPU's decode set and
   launches the kernels of its route;
13. times (device time as in phase 6): both sync kernels against their
   plain versions and bounds at the decodes' sizes; decode_ft8_message ms per
   capture, STANDARD, DEEP, DEEP plus each retry and the deepest stack
   (DEEP + mf_refine + coherent + ap, the CLI's --deep --mf-refine
   --coherent --ap-calls); the stage split of decode_ft8_message (STANDARD,
   DEEP, the deepest stack) and of decode_slots at batch 256 (STANDARD and
   DEEP), host and device ms per ft8.<stage> record_function range of the
   decoders (host ms exclusive of the ranges nested inside: OSD's ft8.osd
   inside ft8.decode, the retries' decodes inside ft8.ap), from profiler
   traces of the real calls; peak device memory;
14. the beacon receiver: the waterfall backends on the card against the
   CPU (waterfall_complex on the block geometry at 12 kHz, the matmul
   backend at 1,999 Hz real and complex, the fft backend at 32,768 Hz
   complex and 48 kHz real) within 1e-3 dB above -100 dB; a
   BeaconSession (12 kHz, max_repeats 8, OSD, coherent, correction,
   refine_fixes) fed in uneven feeds over 8 cycles of a beacon drifting 3
   Hz/s at -11 dB (no raw cycle decodes alone, card and CPU) and a tail
   holding another transmission, then flushed: the beacon reported once,
   first with two or more cycles in the ring, the tail's payload by the
   flush, the CPU's rows (times within 1e-3 s, frequencies within 0.01
   Hz, SNRs within 0.1 dB), the OSD kernel launched in the stacked
   decodes and the frequency-major sync kernel in the flush only, and a
   checkpoint saved after 4.5 cycles resumes with the same rows;
   detect_known_payload at R = 1 and R = 8 and track_known_payload, card
   against CPU; decode_ft8_message on the analytic form of phase 12's
   capture and on a 48-kHz resampling of it (fft backend), card rows ==
   CPU rows, the sync kernel launched; decode_ft8_stacked at 2 kHz, R = 8
   (the stacking results' geometry), card == CPU; times (median of 3, and
   stage splits as in phase 13, with the ranges ft8.stack, ft8.sync_z,
   ft8.detect and ft8.drift): a feed that completes a cycle,
   correct_frequency_drift per cycle, decode_ft8_stacked at R = 1, 4, 8
   and at 2 kHz R = 8, detect_known_payload at R = 8, the complex and
   48-kHz decodes; peak device memory of each;
15. the satellite channel: the Doppler ops (apply_doppler[_physical],
   compensate_linear_doppler[_physical]) on the card against the CPU
   within 2e-5 over the demo's predicted pass (4 cycles at 10 kHz);
   add_complex_awgn's noise power within 2 % of its target at 10 and
   -14 dB; the satellite demo's flow at its full size (4 cycles, Es/N0 -14
   dB, the demo's seed 0, decimated to 2 kHz): one capture made on the
   card (its noise from a seeded torch.Generator), decoded by the demo's
   RX on the card and on the CPU: path A's decode_ft8_message and path
   B's decode_ft8_stacked (R 4, coherent, OSD, the known-call AP) give the
   CPU's rows, path B decodes 'CQ PI4THD JO22', detect_known_payload finds
   the track at 0 s / 500 Hz, the sync and OSD kernels launch; times of
   the ops, the TX + channel, and the RX with its stage split;
16. StreamSession at 12 kHz on 2 minutes (8 blocks) of audio with six
   planted signals at -6 dB (one clipped at capture start, one across the
   first block edge, two 60 Hz apart in one slot, one in the final
   partial block), fed 50,001 samples at a time, at STANDARD and
   DEEP_SEARCH, pipeline_depth 0 and 2: each planted signal reported once
   (time within 0.2 s, frequency within 4 Hz) and nothing else, the CPU's
   rows (score within 1e-4, SNR within 0.1 dB), depth 2 == depth 0, the
   sync kernel launched once a block and the OSD kernel under OSD only; a
   checkpoint saved after 3.5 blocks with blocks in flight (depth 2)
   resumes with the same rows; times: a feed that completes a block
   (median of 5), its device busy and stage split, peak memory;
17. the command line, python -m ft8_demodulator_tpu_torch.cli in processes
   of its own: --tx writes a 12-kHz WAV (--tx-snr -10) on the card and on
   the CPU (the same printed lines, WAVs within 1e-3); the card's WAV
   decoded with the default flags, --deep, --stream and --format json,
   and a 4-cycle 12-kHz beacon WAV at -20 dB with --stack 4 --osd: each
   stdout equal to the same command's with FT8_PLATFORM=cpu, but for a
   printed score or SNR one unit of its last digit apart (counted); the
   message decoded; each process's wall time; --deep once in this process
   with the launch counters (sync and OSD kernels);
18. parallel/ over torch.distributed ranks (parallel.launch.run_ranks, one
   process a rank).  The machine has one card and NCCL takes one rank a
   card, so: (a) NCCL at world size 1: decode_stream on phase 16's stream
   (STANDARD, and use_osd + mf_first) and decode_slot_tp on phase 12's
   crowded capture over a one-rank freq mesh, rows equal to the same rank
   function's on a CPU rank (gloo), each planted signal once; (b) four gloo
   ranks sharing cuda:0 (their collectives cross the host: four ranks on
   one card measure the collectives' overhead and correctness, not
   scaling): dryrun_multichip(4, "gloo", "cuda"), then at 12 kHz DP x SP
   2 x 2 on a 2-channel 60-s capture (three CQs at -6 dB, one across the
   30-s block edge), TP over 4 ranks at osr 2x2 and at 4x4 with OSD and
   the MF retry, PP over 2 stages on 4 slots (OSD) and composed 1 x 2 x 2
   on the capture: every rank's rows equal the same ranks' on the CPU and
   the port's one-rank path on the card (decode_stream / decode_slot_tp
   with mesh None, a per-slot decode for PP), each planted signal once;
   every rank that runs a front launches the sync kernel, and the OSD
   kernel runs where OSD does (each rank of TP 4x4, PP's stage 1); each
   rank's counts (from 0 before the regime's first call) are printed and
   added to the kernels line; host ms of a warm call of each regime to a
   synchronize (the slowest rank), and ms per 2-minute stream at world
   size 1;
19. the reference soak's random coverage (benchmarks/soak.py's draws,
   tests/_torch_soak_cases.py), the card against the CPU: (a) 64 trials
   of decode_ft8_message (seeds 1 and 2 at -10 and -19 dB: random
   payload, rate 2-12 kHz, off-grid f0, start, amplitude 1e-2..1e2, 13.6-
   or 15-s slot, osr 4x4 every 8th trial, osr {3, 5, 10} at 2 or 3 kHz at
   trial 3 of 10, complex baseband at trial 1 of 5, OSD every other;
   mf_first, min_score 1): the card's rows equal the CPU's in every
   trial, every -10-dB trial decodes its payload within soak.py's time,
   frequency and SNR tolerances, and the frequency-major sync kernel's
   launches are counted by (tau, phi) and template instance (the generic
   <false, 0, 0> must launch); (b) decode_slots at batch 4 on 12 drawn
   geometries (rate from soak.py's, time_osr and freq_osr each from {2, 3,
   4}, 13.6- or 15-s slots, STANDARD or DEEP; three signals a slot at -16
   dB and one at -8): the launches of the route's kernels, the card's
   decode sets equal to the CPU's, and at each geometry the waterfall
   kernel (K1 or K3) against its plain version within phase 3's bounds
   (and K3's boxcar as in phase 7), the time-major sync kernel (or, on a
   geometry the block backend does not take, the frequency-major one) and
   the OSD kernel against the CPU route on the LLRs and need mask the
   decode passed it (near ties as in phase 8); any failure raises with its
   reproduction tuple; the phase's seconds;
20. BP + CRC (K7, csrc/ldpc_bp.cu) on the LLRs of phase 4's first BP
   group (5,120 rows) and of phase 12's crowded capture (20 rows): K7 ==
   the plain loop bit for bit (plain, min_errors, both CRCs, iterations),
   device time of K7 and of the plain loop (as in phase 6) beside K7's
   bound (ops/ldpc_cuda.py bp_bound, the rows' own iterations) and the
   rows' iterations; ptxas's report of K7.  Every phase that decodes on
   the card with the counters zeroed just before reads K7's launches there
   and requires them: one a BP group where decode_slots' groups are known
   (phases 4, 6, 9 and 19's slot batches, where a geometry off the block
   route decodes each slot alone), at least one elsewhere; phases
   10 and 13 time calls that phases 9 and 12 count;
21. LLRs (K8, csrc/llr_gather.cu) on the first chunk of phase 4's
   STANDARD decode (16 slots' dB grids, K 20) and of phase 9's DEEP one (8
   slots' boxcar grids, K 40): K8's rows == the plain route's LLRs before
   scaling times the scale that tests/_torch_k8_model.py computes from
   them, bit for bit, that scale within 4 ulp of normalize_llrs', and the
   largest |K8 - normalize_llrs| (the record's max_abs_err); device time
   of K8 and of the plain route (as in phase 6) beside K8's bound
   (ops/llr_cuda.py llr_bound, bytes); a BeaconSession cycle
   (block-spectra matched LLRs) must launch K7 and no K8; ptxas's report
   of both K8 instances (a spill raises).  Every phase that decodes on the
   card with the counters zeroed just before reads K8's launches there
   and requires them: one a chunk of decode_slots' time-major routes
   (phases 4, 6, 9 and 19's slot batches), and elsewhere one a
   frequency-major sync launch on the Hann route and none on the
   matched-filter-first one (phases 12, 16, 18 and 19's trials);
22. the candidate top-K (K9, csrc/topk_select.cu) on K5's scores of the
   first chunk of phase 4's STANDARD decode (16 x 88 x 1,906, K 20) and
   of phase 9's DEEP one (8 x 176 x 3,812, K 40): K9's four outputs ==
   the plain route's (ops/sync.py find_candidates_plain) bit for bit, the
   largest |score difference| (the record's max_abs_err, 0); device time
   of K9 and of the plain route (as in phase 6) beside K9's bound
   (ops/topk_cuda.py topk_bound: the score grid read once); ptxas's
   report of K9 (a spill raises).  Every phase that decodes on the card
   with the counters zeroed just before reads K9's launches there and
   requires one a sync launch: a chunk of decode_slots, a capture and
   pass, a stream block, a decode_slot, a rank's band or slot; a
   BeaconSession's stacked decodes launch it too (R > 1 without a sync
   kernel).

Then one JSON line with the kernels (each with its launches on the main
path, device ms, plain ms, bound ms and what bounds it, and the library
yardstick's ms or null with a note), the nvidia-smi line, and the last
line {"ok": true, "device": {...}}.  Bounds: the larger of the operations
over the card's published peak for their type (989 TFLOP/s bf16 tensor
cores, 67 TFLOP/s outside them, which counts an FMA as two: the sync
stencil's separately rounded adds at 33.5 T/s) and the bytes over 3.35
TB/s, each input read once and each output written once.  Without a CUDA
card it exits 1 and prints no result.  Imports nothing of JAX.
"""

from __future__ import annotations

import functools
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
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
# Below this level (65-80 dB under a noise grid's mean: a few cells in
# millions) two float32 sums of the same products in different orders
# differ by more than ATOL_DB: there the float32 plain version itself is
# up to 1.2e-2 dB off a float64 sum of the same bf16 operands (NVIDIA H100,
# 700 W, this script's float64 reference).  Those cells are held to
# NULL_ATOL_DB, and every line reports both versions against the float64
# reference.
NULL_DB = -100.0
NULL_ATOL_DB = 5e-2
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
OSD_REPLACES = "ft8_demodulator_tpu/ops/osd.py:276 (with _osd_tail, :313)"
# the OSD kernel's timed calls: deep.weak's needed rows among its batch's
# candidates, and deepest.qso's calls of a capture (all rows needed)
OSD_WEAK_ROWS = (3620, 10240)
OSD_QSO_ROWS = (40, 80, 240, 1400, 1678)
# the sync stencil kernels
SYNC_SOURCE = "ft8_demodulator_tpu_torch/csrc/sync_stencil.cu"
K5_REPLACES = "ft8_demodulator_tpu/ops/sync_pallas_tf.py:162"
K6_REPLACES = "ft8_demodulator_tpu/ops/sync_pallas.py:154"
K2_REPLACES = "ft8_demodulator_tpu/ops/waterfall_pallas.py:191"
# the host API on a crowded capture
CROWD_SEED = 11
CROWD_SIGNALS = 15
BURIED_DB = 13.0              # under the strongest signal
API_SCORE_ATOL = 1e-4
API_SNR_ATOL = 0.1
API_REPS = 5
# the host API at an osr the waterfall kernels do not take, on a band crop
HIGH_OSR = 10
HIGH_OSR_BAND_HZ = 300.0
# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W):
# bf16 tensor cores, float32 outside them, device memory
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# PEAK_F32 counts an FMA as two operations: separately rounded adds (the
# bit-exact sync stencil) run at half that rate
PEAK_F32_INSTR = PEAK_F32 / 2
NO_LIBRARY = {
    "osd": "no PyTorch call does GF(2) elimination",
    "sync_scores": "the masks drop a term whose neighbour block lies outside"
                   " the slot, which a zero-padded conv2d would not "
                   "reproduce",
}


def _phase(n: int, text: str) -> None:
    print(f"[{n}] {text}", flush=True)


def _reset_counts() -> None:
    """Zero the program's counters (``utils/profiling.py``)."""
    from ft8_demodulator_tpu_torch.utils.profiling import reset_counters

    reset_counters()


def _counter(name: str) -> int:
    """The program's counter ``name`` since the last :func:`_reset_counts`
    (``k1.launches`` ... ``k6.launches``, ``osd.rows``)."""
    from ft8_demodulator_tpu_torch.utils.profiling import counters

    return counters().get(name, 0)


def _k8_want(k6: int, mf_first: bool) -> int:
    """K8 launches of a frequency-major decode (a decode_ft8_message pass,
    a stream block, a rank's band or slot) whose sync kernel launched
    ``k6`` times: one LLR extraction a sync on the Hann route, none on the
    matched-filter-first route (its LLRs come from the block spectra or a
    direct matched filter)."""
    return 0 if mf_first else k6


def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def _synth_slots(device, fs: float = FS, batch: int = BATCH,
                 seed: int = 42):
    """``batch`` noisy slots at ``fs``, each holding one FT8 signal at 0 dB,
    from numpy.random.default_rng(seed) (bench.py's recipe)."""
    from ft8_demodulator_tpu_torch.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu_torch.protocol import constants as C
    from ft8_demodulator_tpu_torch.protocol.encode import encode_tones

    rng = np.random.default_rng(seed)
    n = int(fs * SLOT_S)
    sps = int(C.SYMBOL_PERIOD_S * fs)
    payloads = rng.integers(0, 256, size=(batch, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    noise = torch.as_tensor(
        rng.standard_normal((batch, n)).astype(np.float32), device=device)
    f0s = (500.0 + 100.0 * rng.integers(0, 40, batch)).astype(np.float32)

    tones = encode_tones(torch.as_tensor(payloads, device=device))
    sig = torch.zeros((batch, n), dtype=torch.float32, device=device)
    for i in range(batch):
        wave = _baseband_complex(tones[i], sps, fs, float(f0s[i])).real
        sig[i, : wave.shape[0]] = wave
        power = torch.mean(wave ** 2)
        sig[i] += noise[i] * torch.sqrt(power)
    return sig, payloads


def _kernel_name(fn: str) -> str:
    """A hand kernel's name from its mangled entry: waterfall_kernel<true>,
    sync_kernel<false,4,4> (layout, then the osr it is built for; 0: any),
    osd_eliminate_kernel, osd_decode_kernel, ldpc_bp_kernel,
    llr_kernel<true> (the boxcar route), topk_select_kernel; other names as
    they are."""
    m = re.search(r"(waterfall_pack_kernel|osd_eliminate_kernel|"
                  r"osd_decode_kernel|"
                  r"ldpc_bp_kernel|llr_kernel|waterfall_kernel|sync_kernel|"
                  r"topk_select_kernel)"
                  r"(?:ILb([01])E((?:Li\d+E)*))?", fn)
    if not m:
        return fn
    name, flag, ints = m.groups()
    if flag is None:
        return name
    args = ["true" if flag == "1" else "false"] + re.findall(r"Li(\d+)E", ints)
    return f"{name}<{','.join(args)}>"


def _ptxas_report(log: str) -> list[str]:
    """ptxas's registers, shared memory and spills, per kernel name."""
    out = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            out.append(_kernel_name(entry.group(1)) + ":")
        elif "registers" in line or "spill" in line or "smem" in line:
            out.append(line.replace("ptxas info    :", "").strip())
    return out


def _sync_ptxas(log: str, kernel: str = "sync_kernel") -> list[str]:
    """ptxas's report of every instance of ``kernel``; raises if one
    spills."""
    report, keep = [], False
    for line in _ptxas_report(log):
        if line.endswith(":"):
            keep = line.startswith(kernel)
        if keep:
            report.append(line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if spill and spill.group(1, 2) != ("0", "0"):
                raise RuntimeError(f"{kernel} spills: {report}")
    return report


# the instructions that show each hand kernel's design: wgmma and TMA loads
# in the waterfall kernels, cp.async and shared-memory loads in the sync
# stencil
SASS_OPS = {"waterfall_kernel": ("HGMMA", "UTMALDG"),
            "sync_kernel": ("LDGSTS", "LDS")}


def _sass_counts(lib_path) -> dict[str, dict[str, int]]:
    """The SASS_OPS instructions of each instance of the waterfall and sync
    kernels in the built library (the sync stencil has one per layout and
    osr specialisation), from cuobjdump -sass."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(cuda_home, "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump") or tool
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = _kernel_name(line.split("Function : ", 1)[1].strip())
            ops = SASS_OPS.get(name.split("<")[0])
            if ops is None:
                name = None
            else:
                counts[name] = dict.fromkeys(ops, 0)
        elif name is not None:
            for op in counts[name]:
                counts[name][op] += bool(re.search(rf"\b{op}\b", line))
    return counts


def _bound(flop: float = 0.0, nbytes: float = 0.0,
           peak_flops: float = PEAK_BF16) -> tuple[float, str]:
    """(the least ms the card could take, what bounds it): the larger of the
    operations over their peak rate and the bytes (each input read once,
    each output written once) over the memory rate."""
    t_ops, t_bytes = flop / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _sync_adds(g, cells: int, grid_values: int) -> int:
    """The FP32 adds the plane design of the sync stencil needs for these
    inputs: one per valid term of every score cell (the search grid's cell,
    prev and next masks), and 3 subtractions per grid value for the H, D
    and P planes."""
    from ft8_demodulator_tpu_torch.ops import sync as so

    terms = sum(int(m.sum()) for m in so.cell_mask_tensors(
        g, torch.device("cpu")))                  # over the num_times rows
    return cells // g.num_times * terms + 3 * grid_values


def _waterfall_bound(p, batch: int, n: int, box: bool) -> tuple[float, str]:
    """The fused waterfall's bound: the DFT's multiply-adds (cos and sin,
    the halo not counted) on the bf16 tensor cores against the audio, the
    cos/sin and combine constants and the output grid(s)."""
    nf = p.num_frames(n)
    nb = nf + p.time_osr - 1
    kx = p.num_freq_bins + 2 * p.freq_osr
    rows = nf + 2 * (p.time_osr - 1)
    nbytes = (4 * batch * n + 2 * 2 * p.hop * kx + 4 * 2 * p.time_osr * kx
              + 4 * batch * nf * p.num_freq_bins
              + (4 * batch * rows * p.num_freq_bins if box else 0))
    return _bound(4 * nb * p.hop * kx * batch, nbytes)


def _waterfall_grid(p, batch: int, box: bool) -> tuple[int, float]:
    """(thread blocks, waves on 132 SMs at one block each) of a fused
    waterfall launch: col tiles x the row tiles of every slot."""
    from ft8_demodulator_tpu_torch.ops import waterfall_cuda as wc

    nf = p.num_frames(int(p.fs * SLOT_S))
    rows = nf + (2 * (p.time_osr - 1) if box else 0)
    row_tiles = -(-rows // (wc.TILE_ROWS - (p.time_osr - 1)))
    col_tiles = -(-p.num_freq_bins // (wc.TILE_COLS - 2 * p.freq_osr))
    blocks = col_tiles * batch * row_tiles
    return blocks, blocks / 132


@functools.lru_cache(maxsize=8)
def _stft_window(n: int, hann: bool, device) -> torch.Tensor:
    """The yardstick's window, made once (outside the timed calls)."""
    if hann:
        return torch.hann_window(n, periodic=True, device=device)
    return torch.ones(n, device=device)


def _library_waterfall(waves, p, num_frames: int, box: bool = False):
    """The yardstick (timed only here, used nowhere in the port): the same
    grid(s) from torch.stft (cuFFT).  A periodic Hann window of nperseg
    centred in nfft, so the audio gets (nfft - nperseg) / 2 zeros at each
    end and frame t starts at sample t*hop; |X|^2 * scale -> dB.  With
    ``box``, a rectangular window over audio padded by a further (tau - 1)
    hop zeros at each end gives the boxcar rows.  Only the nb*hop samples
    the blocks cover are read.  Returns (dB, boxcar or None), time-major
    views."""
    from ft8_demodulator_tpu_torch.ops.waterfall import _db_scale

    nb = num_frames + p.time_osr - 1
    audio = waves[:, : nb * p.hop]
    pad = (p.nfft - p.nperseg) // 2
    win = _stft_window(p.nperseg, True, waves.device)
    spec = torch.stft(torch.nn.functional.pad(audio, (pad, pad)), p.nfft,
                      p.hop, p.nperseg, win, center=False,
                      return_complex=True)[:, : p.num_freq_bins]
    db = 10.0 * torch.log10(1e-12 + spec.abs().square() * _db_scale(p))
    if not box:
        return db.transpose(1, 2), None
    edge = pad + (p.time_osr - 1) * p.hop
    rect = _stft_window(p.nperseg, False, waves.device)
    boxes = torch.stft(torch.nn.functional.pad(audio, (edge, edge)), p.nfft,
                       p.hop, p.nperseg, rect, center=False,
                       return_complex=True)[:, : p.num_freq_bins]
    return db.transpose(1, 2), boxes.abs().square().transpose(1, 2)


def _check_library(waves, p, num_frames: int, box: bool) -> str:
    """The yardstick against the plain float32 waterfall (float64-summed
    block spectra, ops/waterfall.py) on the same inputs: dB within ATOL_DB
    where the plain grid is above -100 dB, the boxcar within BOX_RTOL.
    (The kernel's bf16 operands move dB by ~1e-2, so the bf16 plain version
    is no reference for a float32 FFT.)  Raises if they differ; returns a
    report."""
    from ft8_demodulator_tpu_torch.ops import waterfall as wf

    spec = wf._block_spectrum(waves, p, num_frames)
    want = wf._block_waterfall_tf(spec, p, num_frames)
    db, boxes = _library_waterfall(waves, p, num_frames, box)
    keep = want > -100.0
    err = float((db - want)[keep].abs().max())
    text = f"library dB vs float32 plain {err:.3e}"
    if not err <= ATOL_DB:
        raise RuntimeError(f"torch.stft yardstick at {p.fs} Hz: {text}")
    if box:
        want_box = wf._block_boxcar_tf(spec, p, num_frames)
        rel = float(((boxes - want_box).abs()
                     / (want_box.abs() + want_box.mean())).max())
        text += f", boxcar {rel:.3e}"
        if not rel <= BOX_RTOL:
            raise RuntimeError(f"torch.stft yardstick at {p.fs} Hz: {text}")
    return text


def _exact_db(waves, p, num_frames: int) -> torch.Tensor:
    """The dB grid of the kernels' function in float64 from the same
    bf16-rounded operands: the reference both float32 versions round
    from."""
    from ft8_demodulator_tpu_torch.ops import waterfall as wf
    from ft8_demodulator_tpu_torch.ops import waterfall_cuda as wc

    cos_m, sin_m, wcos, wsin, _ = wc.fused_constants(p, waves.device)
    blocks = wf._blocks(waves, p, num_frames).to(torch.bfloat16).double()
    spec = torch.complex(blocks @ cos_m.double(), blocks @ sin_m.double())
    power = wf._block_power(spec, p, num_frames,
                            (wcos.double(), wsin.double()))
    return (10.0 * torch.log10(1e-12 + power * wf._db_scale(p))).float()


def _check_db(label: str, got, want, exact) -> str:
    """Kernel dB grid against the plain one: |diff| <= ATOL_DB where the
    plain grid is above NULL_DB, <= NULL_ATOL_DB below it.  Raises if not;
    returns a report with both versions against the float64 reference."""
    diff = (got - want).abs()
    deep = want <= NULL_DB
    above = float(diff[~deep].max())
    below = float(diff[deep].max()) if bool(deep.any()) else 0.0
    text = (f"{label} {above:.3e} ({int(deep.sum())} cells <= {NULL_DB:g} dB:"
            f" {below:.3e}; vs float64 kernel "
            f"{float((got - exact).abs().max()):.3e}, plain "
            f"{float((want - exact).abs().max()):.3e})")
    if not (above <= ATOL_DB and below <= NULL_ATOL_DB):
        raise RuntimeError(f"kernel vs plain, dB: {text}, bounds {ATOL_DB}"
                           f" / {NULL_ATOL_DB}")
    return text


def _check_box(label: str, got, want) -> float:
    """The dual-output kernel's boxcar grid against the plain one's:
    |diff| / (|cell| + the grid's mean) <= BOX_RTOL, else raises.  Returns
    that ratio's max."""
    err = float(((got - want).abs() / (want.abs() + want.mean())).max())
    if not err <= BOX_RTOL:
        raise RuntimeError(f"dual-output kernel vs plain at {label}: boxcar "
                           f"{err} (bound {BOX_RTOL})")
    return err


def _decode_sets(res, slots):
    """Per slot: {(payload bytes, abs_time, abs_freq)} of its successes."""
    ok = res.success.cpu().numpy()
    pl = res.payload.cpu().numpy()
    t = res.abs_time.cpu().numpy()
    f = res.abs_freq.cpu().numpy()
    return [{(bytes(pl[b, k]), int(t[b, k]), int(f[b, k]))
             for k in np.flatnonzero(ok[b])} for b in range(slots)]


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# windows _device_ms takes before it gives up.  The profiler has lost all
# of a 22-us kernel's 20 events twice in a row (the OSD timing, right after
# a plain version of 2,405 device events a call), and one of a sync
# kernel's 20 in six and in ten windows in a row, late in a chip_smoke
# process (never in a fresh one; NVIDIA H100 80GB HBM3)
PROFILER_WINDOWS = 10
# a hand kernel's window counts when at most this many of its calls lack a
# device record of their launches
MAX_LOST_CALLS = 2
# the range around each call of a hand kernel's window
CALL_RANGE = "chip_smoke.call"
# unmarked calls before and after a hand kernel's marked ones
MARK_PAD = 2
# profiler windows taken again because they lacked device events ("what
# events-seen/events-expected", or complete calls/calls), and hand-kernel
# windows counted with a call lost ("what complete/calls")
_RETAKEN: list[str] = []
_SHORT: list[str] = []


def _trace_events(fn, reps: int, mark: bool = False) -> list[dict]:
    """The chrome-trace events of a torch.profiler trace of ``reps`` calls
    of ``fn``, up to a synchronize; ``mark`` runs each call in a
    CALL_RANGE range, between MARK_PAD unmarked calls before and after
    (a window's first or last launches may lack a record; the unmarked
    calls count nowhere)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    pad = MARK_PAD if mark else 0
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(pad):
            fn()
        for _ in range(reps):
            if mark:
                with torch.profiler.record_function(CALL_RANGE):
                    fn()
            else:
                fn()
        for _ in range(pad):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _device_events(events: list[dict], name: str | None = None
                   ) -> list[dict]:
    """Kernels, copies and memsets; with ``name`` only the kernels whose
    name holds it."""
    return [e for e in events
            if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS
            and (name is None or (e["cat"] == "kernel"
                                  and name in e.get("name", "")))]


def _busy_ms(events: list[dict]) -> float:
    """The union of the events' intervals, ms."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted((float(e["ts"]), float(e["ts"])
                          + float(e.get("dur", 0.0))) for e in events):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def _complete_calls(events: list[dict], name: str,
                    kernels: int) -> tuple[list[dict], int, list[tuple]]:
    """(the ``name`` kernels of the complete calls, how many calls are
    complete, (index, launches, device records) of the others) in a trace
    of CALL_RANGE calls.  A call is complete when it
    made exactly ``kernels`` launches (the runtime's launch records inside
    its range) and each has its device record (by correlation id), a
    ``name`` kernel."""
    device = {(e.get("args") or {}).get("correlation"): e
              for e in _device_events(events)}
    launches = [(float(e["ts"]), (e.get("args") or {}).get("correlation"))
                for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e.get("name", "")]
    kept, complete, lost = [], 0, []
    calls = sorted((e for e in events if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and e.get("name") == CALL_RANGE),
                   key=lambda e: float(e["ts"]))
    for i, e in enumerate(calls):
        lo = float(e["ts"])
        hi = lo + float(e.get("dur", 0.0))
        mine = {c for t, c in launches if lo <= t <= hi}
        got = [device[c] for c in mine if c in device
               and name in device[c].get("name", "")]
        if len(mine) == kernels and len(got) == kernels:
            kept += got
            complete += 1
        else:
            lost.append((i, len(mine), len(got)))
    return kept, complete, lost


def _device_ms(fn, reps: int, name: str | None = None,
               kernels: int = 1) -> tuple[float, int]:
    """(device ms per call of ``fn``, device events per call): the union of
    the device intervals of a torch.profiler trace over ``reps`` warm
    calls, divided by the calls.  ``name``: only the kernels whose name
    holds it (a hand kernel; its wrapper launches exactly ``kernels`` of
    them per call).

    A plain version's window counts only when it holds at least ``reps``
    times the device events of a one-call trace (a plain call's allocator
    may add a memset or copy now and then; such events count in the
    union).  A hand kernel's window counts the calls whose every launch has
    its device record (matched by correlation id) and the union of their
    kernels' intervals, when at most MAX_LOST_CALLS calls lack one (noted
    in ``_SHORT``).  A window short of that is taken again (and noted in
    ``_RETAKEN``), up to PROFILER_WINDOWS windows; then it raises."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_WINDOWS):
        if name:
            kept, complete, lost = _complete_calls(
                _trace_events(fn, reps, True), name, kernels)
            if complete >= reps - MAX_LOST_CALLS:
                if complete < reps:
                    _SHORT.append(f"{name} {complete}/{reps} {lost}")
                return _busy_ms(kept) / complete, kernels
            _RETAKEN.append(f"{name} {complete}/{reps} calls {lost}")
            continue
        per_call = len(_device_events(_trace_events(fn, 1)))
        events = _device_events(_trace_events(fn, reps))
        if per_call > 0 and len(events) >= reps * per_call:
            return _busy_ms(events) / reps, per_call
        _RETAKEN.append(f"plain {len(events)}/{reps * per_call}")
    raise RuntimeError(f"{PROFILER_WINDOWS} incomplete profiler windows: "
                       f"{_RETAKEN[-PROFILER_WINDOWS:]}")


def _kernel_vs_plain_ms(kernel, plain, name: str, reps: int = 20,
                        plain_reps: int | None = None, kernels: int = 1,
                        library=None) -> tuple[float, float, int, float]:
    """(kernel ms, plain ms, the plain version's device events per call,
    library ms or None) of device time, warm, min of 2 counted windows
    each, in the order plain, kernel, library, library, kernel, plain
    (without ``library``: plain, kernel, kernel, plain).  ``kernels``: the
    hand kernels one call of ``kernel`` launches."""
    times = {"plain": [], "kernel": [], "library": []}
    order = ("plain", "kernel", "library", "library", "kernel", "plain")
    for which in order:
        if which == "kernel":
            times[which].append(_device_ms(kernel, reps, name, kernels)[0])
        elif which == "library":
            if library is not None:
                times[which].append(_device_ms(library, reps)[0])
        else:
            ms, per_call = _device_ms(plain, plain_reps or reps)
            times[which].append(ms)
    return (min(times["kernel"]), min(times["plain"]), per_call,
            min(times["library"]) if times["library"] else None)


def _tied_orders(rows: int, seed: int, device):
    """Reliability orders (the OSD kernel's input) of random LLRs, a fifth
    of them zero (tied)."""
    rng = np.random.default_rng(seed)
    llr = rng.standard_normal((rows, 174)).astype(np.float32)
    llr[rng.random(llr.shape) < 0.2] = 0.0
    llr = torch.as_tensor(llr, device=device)
    return torch.sort(-llr.abs(), dim=-1, stable=True).indices


def _check_osd(order, tables, label: str) -> None:
    """The OSD kernel against its plain version on ``order``, bit for
    bit; raises if any row differs."""
    from ft8_demodulator_tpu_torch.ops import osd_cuda as oc

    red, pcol = oc.reduce_basis_from_order(order, tables)
    torch.cuda.synchronize()
    want_red, want_pcol = oc.reduce_basis_from_order_plain(order, tables)
    if not (torch.equal(red, want_red) and torch.equal(pcol, want_pcol)):
        bad = int(((red != want_red).any(-1).any(-1)
                   | (pcol != want_pcol).any(-1)).sum())
        raise RuntimeError(f"OSD kernel vs plain on {label}: {bad} of "
                           f"{order.shape[0]} rows differ")


def _osd_bound(rows: int, needed: int) -> tuple[float, str]:
    """The OSD kernel's bound.  Bytes: the need mask read and the codewords
    and flags written for every row, the LLRs of the needed rows read, the
    table once.  Operations, a needed row: the integer ones (the rank's
    174 x 174 key compares and the elimination's XORs of six words a row
    and pivot, 91 x 90 x 6) and the float32 adds (each of the 91 rows'
    corrections and each of the order-2 pairs' overlaps over 174 columns).
    Integer operations issue on half of the float32 lanes (64 of 128 an SM
    a clock) and share them with the adds, so the least time is the larger
    of 2 x int and int + adds at PEAK_F32_INSTR."""
    from ft8_demodulator_tpu_torch.ops import osd
    from ft8_demodulator_tpu_torch.ops.osd_cuda import TABLE_WORDS

    pairs = osd.DEFAULT_ORDER2 * (osd.DEFAULT_ORDER2 - 1) // 2
    int_ops = 174 * 174 + 91 * 90 * 6
    adds = (91 + pairs) * 174
    return _bound(needed * max(2 * int_ops, int_ops + adds),
                  rows * (1 + 4 * 174 + 1) + needed * 4 * 174
                  + 4 * TABLE_WORDS, PEAK_F32_INSTR)


def _cliff_osd_rows(rows: int, seed: int, device):
    """(LLRs, need): random codewords at the BP cliff on a grid of halves
    (tied magnitudes), a tenth of the values zero of either sign, 40 %
    of the rows needed."""
    from ft8_demodulator_tpu_torch.protocol import constants as pc

    rng = np.random.default_rng(seed)
    pay = rng.integers(0, 2, (rows, 77)).astype(np.float32)
    cw = (pay @ pc.ENCODE_MATRIX.T) % 2
    llr = np.round(((2 * cw - 1) * 2.0 + 1.5 * rng.standard_normal(
        cw.shape)) * 2) / 2
    llr[rng.random(llr.shape) < 0.05] = 0.0
    llr[rng.random(llr.shape) < 0.05] = -0.0
    return (torch.as_tensor(llr.astype(np.float32), device=device),
            torch.as_tensor(rng.random(rows) < 0.4, device=device))


def _check_osd_decode(llr, need, label: str) -> tuple[str, dict]:
    """The OSD kernel (one launch) against the CPU route on (llr, need):
    plain and ok equal on every row but the near ties the numpy model names
    (tests/_torch_k4_model.py: an admissible distance within 1e-5 relative
    of the smallest, or a valid candidate's distance within 1e-5 of the
    gate, by a gap that is not zero), and equal to the model bit for bit on
    every needed row.  Raises on any other difference.  Returns a summary
    and what it measured: the rows that differ from the CPU route, those of
    them that are near ties, and the largest |plain difference| over all
    rows, near ties included."""
    from ft8_demodulator_tpu_torch.ops import osd

    k4m = _tests_module("_torch_k4_model")
    llr, need = llr.reshape(-1, 174), need.reshape(-1)
    plain, ok = osd.osd_kernel(llr, need, osd.osd_tables(llr.device),
                               osd.DEFAULT_LAMBDA, osd.DEFAULT_ORDER2,
                               osd.DEFAULT_ORDER3)
    torch.cuda.synchronize()
    want_plain, want_ok = osd.osd_decode_masked(llr.cpu(), need.cpu())
    plain, ok, needc = plain.cpu(), ok.cpu(), need.cpu()
    differ = (plain != want_plain).any(-1) | (ok != want_ok)
    if bool(ok[~needc].any()) or bool((plain[~needc] != 0).any()):
        raise RuntimeError(f"OSD kernel on {label}: an unneeded row is not "
                           "(zeros, False)")
    near = torch.zeros_like(needc)
    idx = needc.nonzero()[:, 0]
    search = k4m.decode(llr[idx].cpu().numpy())
    near[idx] = torch.as_tensor(k4m.near_ties(search))
    if bool((differ & ~near).any()):
        raise RuntimeError(f"OSD kernel vs the CPU route on {label}: "
                           f"{int((differ & ~near).sum())} of {len(idx)} "
                           f"needed rows differ beyond near ties")
    if not (torch.equal(plain[idx], torch.as_tensor(search.plain))
            and torch.equal(ok[idx], torch.as_tensor(search.ok))):
        raise RuntimeError(f"OSD kernel vs its numpy model on {label}")
    measured = {"rows_differ": int(differ.sum()),
                "near_tie_rows_differ": int((differ & near).sum()),
                "max_abs_err": float((plain - want_plain).abs().max())
                if plain.numel() else 0.0}
    return (f"{len(idx)} needed of {needc.numel()} rows, {int(ok.sum())} "
            f"accepted, {int(near.sum())} near ties, "
            f"{measured['rows_differ']} rows differ (max |plain diff| "
            f"{measured['max_abs_err']:g}); == the model bit for bit",
            measured)


def _capture_osd_inputs(fn) -> list:
    """Run ``fn`` (a decode) with ops/osd.py's kernel entry wrapped to keep
    each call's (llr, need); the entry is restored after."""
    from ft8_demodulator_tpu_torch.ops import osd

    seen, entry = [], osd.osd_kernel

    def keep(llr, need, *args):
        seen.append((llr, need))
        return entry(llr, need, *args)

    osd.osd_kernel = keep
    try:
        fn()
    finally:
        osd.osd_kernel = entry
    return seen


def _replaced_osd_route(llr, need):
    """ops/osd.py's OSD of a masked call on the card before the fused
    kernel: the needed rows compacted by nonzero, torch.sort, the
    elimination entry, _osd_tail in passes of 1,024 rows, scattered back."""
    from ft8_demodulator_tpu_torch.ops import osd

    plain = torch.zeros(llr.shape, dtype=torch.int32, device=llr.device)
    ok = torch.zeros(need.shape, dtype=torch.bool, device=llr.device)
    idx = need.nonzero()[:, 0]
    if idx.numel():
        plain[idx], ok[idx] = osd._osd_rows(
            llr[idx], osd.DEFAULT_LAMBDA, osd.DEFAULT_ORDER2,
            osd.DEFAULT_ORDER3, osd.DEFAULT_CHUNK)
    return plain, ok


def _plain_osd_route(llr, need):
    """The same with the plain elimination: all PyTorch."""
    from ft8_demodulator_tpu_torch.ops import osd
    from ft8_demodulator_tpu_torch.ops import osd_cuda as oc

    entry = osd.reduce_basis_from_order
    osd.reduce_basis_from_order = oc.reduce_basis_from_order_plain
    try:
        return _replaced_osd_route(llr, need)
    finally:
        osd.reduce_basis_from_order = entry


def _wall_ms(fn, reps: int) -> float:
    """Wall ms a call of ``fn``, back to back after a warm call, ended by a
    synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _osd_times(llr, need, reps: int = 20) -> dict:
    """The OSD kernel's device ms, its bound, the replaced and plain
    routes' device ms and events, and the wall ms a call of the kernel's
    route (osd_decode_masked) and of the replaced one, on (llr, need)."""
    from ft8_demodulator_tpu_torch.ops import osd

    tables = osd.osd_tables(llr.device)
    needed = int(need.sum())
    kernel = lambda: osd.osd_kernel(llr, need, tables, osd.DEFAULT_LAMBDA,
                                    osd.DEFAULT_ORDER2, osd.DEFAULT_ORDER3)
    ms, rep_ms, rep_ev, _ = _kernel_vs_plain_ms(
        kernel, lambda: _replaced_osd_route(llr, need), "osd_decode_kernel",
        reps)
    plain_ms, plain_ev = _device_ms(lambda: _plain_osd_route(llr, need), 2)
    return {"rows": llr.shape[0], "needed": needed, "ms": ms,
            "bound": _osd_bound(llr.shape[0], needed),
            "replaced_ms": rep_ms, "replaced_events": rep_ev,
            "plain_ms": plain_ms, "plain_events": plain_ev,
            "wall_ms": _wall_ms(lambda: osd.osd_decode_masked(llr, need),
                                reps),
            "replaced_wall_ms": _wall_ms(
                lambda: _replaced_osd_route(llr, need), reps)}


def _osd_text(label: str, t: dict) -> str:
    return (f"{label}: {t['needed']} needed of {t['rows']} rows, kernel "
            f"{t['ms'] * 1e3:.1f} us (bound {t['bound'][0] * 1e3:.2f} us by "
            f"{t['bound'][1]}), replaced route {t['replaced_ms'] * 1e3:.1f} "
            f"us ({t['replaced_events']} device events), plain route "
            f"{t['plain_ms']:.2f} ms ({t['plain_events']} events); wall a "
            f"call {t['wall_ms']:.3f} ms, replaced route "
            f"{t['replaced_wall_ms']:.3f} ms")


def _deep_phases(dev, smi: str, waves, payloads) -> list[dict]:
    """Phases 7-10: the DEEP decode's kernels and path.  Returns the
    kernels' JSON records."""
    from ft8_demodulator_tpu_torch.demod.decode import decode_slots
    from ft8_demodulator_tpu_torch.ops import osd
    from ft8_demodulator_tpu_torch.ops import osd_cuda as oc
    from ft8_demodulator_tpu_torch.ops import waterfall_cuda as wc
    from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu_torch.utils.build import kernel_library

    mf = wc.block_waterfall_mf_tf_fused_batch
    mf_plain = wc.block_waterfall_mf_tf_fused_batch_plain
    db_errs, db_text, box_errs, lib_text = {}, {}, {}, ""
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
        db_text[fs] = _check_db(f"{fs / 1000:g} kHz", db, want_db,
                                _exact_db(w8, p, nf))
        box_errs[fs] = _check_box(f"{fs} Hz", box, want_box)
        if fs == 12000.0:
            single = wc.block_waterfall_tf_fused_batch(w8, p, nf)
            torch.cuda.synchronize()
            db_vs_single = float((db - single).abs().max())
            if not db_vs_single <= ATOL_DB:
                raise RuntimeError(f"dual-output dB vs dB-only kernel: "
                                   f"{db_vs_single} > {ATOL_DB}")
            lib_text = _check_library(w8, p, nf, box=True)
    _phase(7, "dual-output kernel vs plain at osr 4x4, batch "
              f"{DEEP_CHUNK}: dB max |diff| "
              + ", ".join(db_text.values())
              + f" (bounds {ATOL_DB} / {NULL_ATOL_DB}); boxcar max |diff| / "
                f"(|cell| + mean) "
              + ", ".join(f"{fs / 1000:g} kHz {e:.3e}"
                          for fs, e in box_errs.items())
              + f" (bound {BOX_RTOL}); dB vs the dB-only kernel at 12 kHz "
                f"{db_vs_single:.3e}; the torch.stft yardstick at 12 kHz: "
              + lib_text)

    tables = osd.osd_tables(dev)
    for rows, seed in ((4099, 1), (37, 2)):
        _check_osd(_tied_orders(rows, seed, dev), tables, f"{rows} orders")
    cliff_text, _ = _check_osd_decode(*_cliff_osd_rows(2000, 8, dev),
                                      "2,000 cliff rows")
    k4_ptxas = _sync_ptxas(kernel_library().log, "osd_decode_kernel")
    _phase(8, "OSD kernel's elimination entry (order -> reduced bases, one "
              "launch) == plain (permute-pack + elimination) bit for bit on "
              "4099 and 37 rows (random LLRs, 20 % zero ties); the whole OSD "
              "(one launch) == the CPU route but near ties, and == its numpy "
              "model bit for bit, on cliff rows with ties and signed zeros: "
              f"{cliff_text}; "
              "ptxas: " + " ".join(k4_ptxas))

    p = waterfall_params(FS, *DEEP_OSR)
    nf = p.num_frames(waves.shape[1])
    kw = dict(max_candidates=DEEP_CANDIDATES, min_score=DEEP_MIN_SCORE,
              max_iterations=BP_ITERATIONS, mf_first=True, chunk=DEEP_CHUNK,
              bp_chunk=BP_CHUNK)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = decode_slots(waves, p, nf, use_osd=True, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    mf_launches = _counter("k3.launches")
    k5_launches = _counter("k5.launches")
    osd_launches = _counter("k4.launches")
    osd_rows = _counter("osd.rows")
    bp_launches = _counter("k7.launches")
    llr_launches = _counter("k8.launches")
    topk_launches = _counter("k9.launches")
    if mf_launches != BATCH // DEEP_CHUNK \
            or k5_launches != BATCH // DEEP_CHUNK \
            or llr_launches != BATCH // DEEP_CHUNK \
            or topk_launches != BATCH // DEEP_CHUNK:
        raise RuntimeError(f"dual-output / sync / LLR / top-K kernels "
                           f"launched {mf_launches} / {k5_launches} / "
                           f"{llr_launches} / {topk_launches} times, want "
                           f"{BATCH // DEEP_CHUNK}")
    if bp_launches != BATCH // BP_CHUNK:
        raise RuntimeError(f"BP + CRC kernel launched {bp_launches} times, "
                           f"want one a BP group, {BATCH // BP_CHUNK}")
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
    # the rows BP leaves: valid candidates without a BP + CRC decode
    needed = int((bp_only.candidate_valid & ~bp_only.success).sum())
    if osd_launches != 1 or osd_rows != needed:
        raise RuntimeError(f"OSD kernel: {osd_launches} launches over "
                           f"{osd_rows} rows, want 1 over the {needed} rows "
                           "BP left")
    seen = _capture_osd_inputs(
        lambda: decode_slots(waves, p, nf, use_osd=True, **kw))
    if len(seen) != 1 or int(seen[0][1].sum()) != needed:
        raise RuntimeError(f"the uncounted DEEP call gave the OSD kernel "
                           f"{[int(n.sum()) for _, n in seen]} needed rows")
    deep_llr, deep_need = seen[0]
    deep_text, deep_check = _check_osd_decode(
        deep_llr, deep_need, f"the DEEP call's {needed} rows")
    _phase(9, f"DEEP decode_slots {BATCH} slots at {FS / 1000:g} kHz osr "
              f"{DEEP_OSR[0]}x{DEEP_OSR[1]}: yield {decoded}/{BATCH}, "
              f"dual-output kernel launches {mf_launches}, sync kernel "
              f"launches {k5_launches}, LLR kernel launches {llr_launches}, "
              f"BP + CRC kernel launches {bp_launches}, OSD kernel "
              f"launches {osd_launches} reducing {osd_rows} rows (the rows "
              f"BP left), {int(res.success.sum())} successful rows of which "
              f"{osd_accepted} OSD-accepted, {unplanted} unplanted decodes, "
              f"first call {first_s:.2f} s; OSD kernel == the CPU route on "
              f"that call's rows: {deep_text}")

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
    mf_ms, mf_plain_ms, mf_plain_ev, mf_lib_ms = _kernel_vs_plain_ms(
        lambda: mf(w8, p, nf, consts), lambda: mf_plain(w8, p, nf, consts),
        "waterfall", kernels=2,
        library=lambda: _library_waterfall(w8, p, nf, box=True))
    kx = p.num_freq_bins + 2 * p.freq_osr
    dft_flop = 4 * (nf + p.time_osr - 1) * p.hop * kx * DEEP_CHUNK
    mf_bound = _waterfall_bound(p, DEEP_CHUNK, waves.shape[1], box=True)
    mf_ctas, mf_waves = _waterfall_grid(p, DEEP_CHUNK, box=True)
    # the OSD kernel at the DEEP call's rows (its one launch a batch), at
    # deep.weak's and at deepest.qso's calls
    weak_llr, _ = _cliff_osd_rows(OSD_WEAK_ROWS[1], 9, dev)
    weak_need = torch.zeros(OSD_WEAK_ROWS[1], dtype=torch.bool, device=dev)
    weak_need[torch.randperm(OSD_WEAK_ROWS[1], generator=torch.Generator()
                             .manual_seed(9))[:OSD_WEAK_ROWS[0]]] = True
    osd_t = {"DEEP": _osd_times(deep_llr, deep_need),
             "deep.weak": _osd_times(weak_llr, weak_need)}
    for rows in OSD_QSO_ROWS:
        llr, _ = _cliff_osd_rows(rows, rows, dev)
        osd_t[f"deepest.qso {rows}"] = _osd_times(
            llr, torch.ones(rows, dtype=torch.bool, device=dev))
    # one row's chain, on deepest.qso's smallest call: the whole kernel,
    # the kernel at order2 0 (no pairs) and the elimination entry alone on
    # the rows' stable sort order
    chain_llr, _ = _cliff_osd_rows(OSD_QSO_ROWS[0], OSD_QSO_ROWS[0], dev)
    chain_need = torch.ones(OSD_QSO_ROWS[0], dtype=torch.bool, device=dev)
    chain_order = torch.sort(-chain_llr.abs(), dim=-1, stable=True).indices
    chain = {
        "order2 0": _device_ms(lambda: osd.osd_kernel(
            chain_llr, chain_need, tables, osd.DEFAULT_LAMBDA, 0, 0), 20,
            "osd_decode_kernel")[0],
        "elimination only": _device_ms(
            lambda: oc.reduce_basis_from_order(chain_order, tables), 20,
            "osd_eliminate_kernel")[0]}

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
               f"{FS / 1000:g} kHz osr 4x4 (pre-pass + kernel, {mf_ctas} "
               f"thread blocks, {mf_waves:.2f} waves): kernel {mf_ms:.4f} ms "
               f"({dft_flop / (mf_ms * 1e-3) / 1e12:.1f} TFLOP/s of DFT, "
               f"bound {mf_bound[0]:.4f} ms by {mf_bound[1]}), "
               f"plain {mf_plain_ms:.4f} ms ({mf_plain_ev} device events "
               f"per call), torch.stft yardstick {mf_lib_ms:.4f} ms; OSD "
               f"kernel (LLRs and need in, codewords out; device time, min "
               f"of 2 counted windows): "
               + "; ".join(_osd_text(k, t) for k, t in osd_t.items())
               + f"; one row's chain at {OSD_QSO_ROWS[0]} rows: whole "
               f"{osd_t[f'deepest.qso {OSD_QSO_ROWS[0]}']['ms'] * 1e3:.1f} "
               "us, " + ", ".join(f"{k} {v * 1e3:.1f} us"
                                  for k, v in chain.items())
               + f"; per DEEP batch {osd_launches} launch; DEEP "
               f"decode_slots batch {BATCH}: slots/s over {DEEP_REPS} runs "
               f"min {rates[0]:.1f}, median {rates[len(rates) // 2]:.1f}, "
               f"max {rates[-1]:.1f}; peak memory {peak_mib:.1f} MiB")
    return rates, peak_mib, k5_launches, [
        {"name": "waterfall_mf_tf", "route": "cuda",
         "source": KERNEL_SOURCE, "replaces": MF_REPLACES,
         "launches": mf_launches,
         "max_abs_err": max(db_errs.values()), "ms": mf_ms,
         "plain_ms": mf_plain_ms, "bound_ms": mf_bound[0],
         "bound_by": mf_bound[1], "library_ms": mf_lib_ms},
        {"name": "osd", "route": "cuda", "source": OSD_SOURCE,
         "replaces": OSD_REPLACES, "launches": osd_launches,
         "max_abs_err": deep_check["max_abs_err"],
         "near_tie_rows_differ": deep_check["near_tie_rows_differ"],
         "ms": osd_t["DEEP"]["ms"],
         "plain_ms": osd_t["DEEP"]["plain_ms"],
         "bound_ms": osd_t["DEEP"]["bound"][0],
         "bound_by": osd_t["DEEP"]["bound"][1], "library_ms": None,
         "library_note": NO_LIBRARY["osd"]},
    ]


def _check_sync(label: str, got, want) -> float:
    """A sync kernel's scores against its plain version's: bit for bit
    (torch.equal, identical -inf masks), else raises.  Returns the max
    |difference| over the finite scores."""
    torch.cuda.synchronize()
    if got.shape != want.shape or bool(torch.isnan(got).any()):
        raise RuntimeError(f"{label}: malformed scores {tuple(got.shape)}")
    if not torch.equal(torch.isneginf(got), torch.isneginf(want)):
        raise RuntimeError(f"{label}: -inf masks differ")
    fin = torch.isfinite(want)
    diff = float((got - want)[fin].abs().max()) if bool(fin.any()) else 0.0
    if not torch.equal(got, want):
        raise RuntimeError(f"{label}: not bit for bit, max |diff| {diff}")
    return diff


def _sync_phase(dev, log: str):
    """Phase 11: both sync kernels against their plain versions, bit for
    bit.  Returns ({label: max |diff|}, the time-major (STANDARD, DEEP)
    chunk grids and the frequency-major (STANDARD, DEEP) captures)."""
    from ft8_demodulator_tpu_torch.ops import sync as so
    from ft8_demodulator_tpu_torch.ops import sync_cuda as sc
    from ft8_demodulator_tpu_torch.ops import waterfall_cuda as wc
    from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

    diffs = {}

    def check(label, got, want):
        diffs[label] = _check_sync(label, got, want)

    chunks, captures = [], []
    # (time_osr, freq_osr); 3x1 and 10x10 run the generic instance
    # (checked, not timed; 10x10 on a shrunk tile, from the plain
    # waterfall: the waterfall kernels stop at time_osr 8)
    for fs, (tau, phi), b in ((12000.0, (2, 2), CHUNK),
                              (12000.0, (4, 4), DEEP_CHUNK),
                              (2000.0, (2, 2), 3), (12000.0, (3, 1), 2),
                              (12000.0, (10, 10), 2)):
        p = waterfall_params(fs, phi, tau)
        ns = int(fs * SLOT_S)
        nf = p.num_frames(ns)
        rng = np.random.default_rng(int(fs) + tau)
        w = torch.as_tensor(rng.standard_normal((b, ns)).astype(np.float32),
                            device=dev)
        waterfall = (wc.block_waterfall_tf_fused_batch_plain
                     if tau > wc.MAX_TAU else
                     wc.block_waterfall_tf_fused_batch)
        mag_tf = waterfall(w, p, nf)
        g = so.search_grid(p.num_freq_bins, nf, tau, phi)
        check(f"K5 {fs / 1000:g} kHz {tau}x{phi} batch {b}",
              sc.sync_scores_tf_kernel(mag_tf, g),
              so.sync_scores_tf(mag_tf, g))
        if fs != FS:
            continue
        mag = mag_tf[0].transpose(0, 1).contiguous()        # one capture
        check(f"K6 {fs / 1000:g} kHz {tau}x{phi}",
              sc.sync_scores_kernel(mag, g), so.sync_scores(mag, g))
        if tau != phi or tau > wc.MAX_TAU:
            continue
        chunks.append((mag_tf, g))
        captures.append((mag, g))
        if tau == 2:
            crop = mag[200:1400, 6:170]
            gc = so.search_grid(*crop.shape, tau, phi)
            check("K6 cropped view", sc.sync_scores_kernel(crop, gc),
                  so.sync_scores(crop.contiguous(), gc))
    tiles = {f"{'K5' if tm else 'K6'} 10x10": sc.sync_tile(tm, 10, 10)
             for tm in (True, False)}
    # the limits left: the sync kernel's largest tile and the waterfall
    # kernels' MAX_TAU raise a ValueError before any launch
    refused = []
    for label, call in (
            ("K6 18x18", lambda: sc.sync_scores_kernel(
                torch.zeros((200, 1500), device=dev),
                so.search_grid(200, 1500, 18, 18))),
            ("K5 20x20", lambda: sc.sync_scores_tf_kernel(
                torch.zeros((1700, 200), device=dev),
                so.search_grid(200, 1700, 20, 20))),
            ("waterfall time_osr 10",
             lambda: wc.block_waterfall_tf_fused_batch(
                 torch.zeros((1, int(FS * SLOT_S)), device=dev),
                 waterfall_params(FS, 2, 10), 900))):
        try:
            call()
        except ValueError as err:
            refused.append(f"{label}: {err}")
        else:
            raise RuntimeError(f"{label} did not raise a ValueError")
    torch.cuda.synchronize()
    _phase(11, "sync kernels vs plain, bit for bit (torch.equal, -inf masks "
               "equal), max |diff| "
               + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
               + "; tiles at 10x10 (start times a thread, lanes, shared "
               "bytes): " + ", ".join(f"{k} {v}" for k, v in tiles.items())
               + "; refused: " + " | ".join(refused)
               + "; ptxas: " + " ".join(_sync_ptxas(log)))
    return diffs, chunks, captures


def _crowded_capture():
    """One 15-s 12 kHz capture from numpy.random.default_rng(CROWD_SEED):
    CROWD_SIGNALS signals at SNRs spread evenly over -12..+5 dB (in 2500
    Hz, unit noise), 300-2750 Hz, >= 60 Hz apart, starting in 0-1.5 s,
    plus a buried one BURIED_DB under the strongest, 30 Hz above it and
    one symbol later.  Returns (wave (n,) float32 numpy, payloads (16,
    10), snr_db (16,), f0 Hz (16,)); the buried one is last."""
    from ft8_demodulator_tpu_torch.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu_torch.protocol import constants as C
    from ft8_demodulator_tpu_torch.protocol.encode import encode_tones

    rng = np.random.default_rng(CROWD_SEED)
    n = int(FS * SLOT_S)
    sps = int(C.SYMBOL_PERIOD_S * FS)
    while True:
        f0 = np.sort(rng.uniform(300.0, 2750.0, CROWD_SIGNALS))
        if np.diff(f0).min() >= 60.0:
            break
    snr = rng.permutation(np.linspace(-12.0, 5.0, CROWD_SIGNALS))
    starts = (rng.uniform(0.0, 1.5, CROWD_SIGNALS) * FS).astype(int)
    payloads = rng.integers(0, 256, (CROWD_SIGNALS + 1, 10), dtype=np.uint8)
    payloads[:, 9] &= 0xF8
    wave = rng.standard_normal(n)
    strong = int(np.argmax(snr))
    f0 = np.append(f0, f0[strong] + 30.0)
    snr = np.append(snr, snr[strong] - BURIED_DB)
    starts = np.append(starts, starts[strong] + sps)
    tones = encode_tones(torch.as_tensor(payloads))
    for i in range(CROWD_SIGNALS + 1):
        sig = _baseband_complex(tones[i], sps, FS, float(f0[i])).real.numpy()
        amp = np.sqrt(2.0 * 10.0 ** (snr[i] / 10.0) * 2500.0 / (FS / 2.0))
        wave[starts[i]: starts[i] + len(sig)] += amp * sig
    return wave.astype(np.float32), payloads, snr, f0


DEEP_API = dict(bins_per_tone=4, steps_per_symbol=4, max_candidates=40,
                min_score=1.0, use_osd=True, use_mf=True)
AP_CALLS = "K1ABC W9XYZ"
# the deep retries, each on top of DEEP_API: every one decodes what DEEP
# decodes and more or the same
RETRY_RUNS = {
    "mf_refine": dict(mf_refine=True),
    "mf_first+mf_refine": dict(use_mf=False, mf_first=True, mf_refine=True),
    "coherent": dict(coherent=True),
    "ap": dict(ap=AP_CALLS),
    "coherent+ap": dict(coherent=True, ap=AP_CALLS),
}
# the CLI's deepest stack: --deep --mf-refine --coherent --ap-calls
DEEPEST = dict(DEEP_API, mf_refine=True, coherent=True, ap=AP_CALLS)
# (options, every planted signal at or above this SNR must decode)
API_RUNS = {
    "STANDARD": ({}, -4.0),
    "DEEP": (DEEP_API, 0.0),
    "mf_first": (dict(DEEP_API, use_mf=False, mf_first=True), 0.0),
    "passes=2": (dict(passes=2), -11.0),
    **{name: (dict(DEEP_API, **kw), 0.0) for name, kw in RETRY_RUNS.items()},
}
# a capture of weak off-grid CQ transmissions, packed by the port's message
# codec, where DEEP misses some that the coherent or a-priori retry finds:
# SNRs (2500-Hz convention) spread evenly over WEAK_SNR_DB
WEAK_SEED = 6
WEAK_MESSAGES = ("CQ K1ABC FN42", "CQ W9XYZ EN37", "CQ DL1ABC JO62",
                 "CQ JA1XYZ PM95", "CQ VK2ABC QF56", "CQ G4XYZ IO91")
WEAK_SNR_DB = (-22.0, -19.0)
WEAK_RUNS = {"DEEP": {}, "coherent": dict(coherent=True),
             "ap": dict(ap=True), "coherent+ap": dict(coherent=True, ap=True)}


def _check_api_rows(name: str, card, host) -> None:
    """The card's rows against the CPU's: the same payloads, times and
    frequencies, scores within API_SCORE_ATOL, SNRs within API_SNR_ATOL."""
    if [(r.message.payload, r.time_sec, r.freq_hz) for r in card] != \
            [(r.message.payload, r.time_sec, r.freq_hz) for r in host]:
        raise RuntimeError(f"{name}: card rows "
                           f"{[r.message.payload for r in card]} != CPU rows "
                           f"{[r.message.payload for r in host]}")
    for a, b in zip(card, host):
        if abs(a.score - b.score) > API_SCORE_ATOL \
                or abs(a.snr_db - b.snr_db) > API_SNR_ATOL:
            raise RuntimeError(f"{name}: card score / SNR {a.score} / "
                               f"{a.snr_db}, CPU {b.score} / {b.snr_db}")


def _api_phase(dev) -> tuple[int, dict]:
    """Phase 12: decode_ft8_message on the crowded capture, card vs CPU.
    Returns (frequency-major sync kernel launches, card rows per run)."""
    from ft8_demodulator_tpu_torch.demod.decode import decode_ft8_message

    wave, payloads, snr, f0 = _crowded_capture()
    planted = {bytes(pl): float(s) for pl, s in zip(payloads, snr)}
    buried = bytes(payloads[-1])
    k6_total, out, lines = 0, {}, []
    for name, (kw, min_snr) in API_RUNS.items():
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        card = decode_ft8_message(wave, FS, device=dev, **kw)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        k6 = _counter("k6.launches")
        k4 = _counter("k4.launches")
        k7 = _counter("k7.launches")
        k8 = _counter("k8.launches")
        k9 = _counter("k9.launches")
        k6_total += k6
        host = decode_ft8_message(wave, FS, device="cpu", **kw)
        got = [r.message.payload for r in card]
        if k6 < 1 or k7 < 1 or (kw.get("use_osd") and k4 < 1) \
                or k8 != _k8_want(k6, kw.get("mf_first", False)) \
                or k9 != k6:
            raise RuntimeError(f"{name}: sync kernel {k6}, OSD kernel {k4}, "
                               f"BP + CRC kernel {k7}, LLR kernel {k8}, "
                               f"top-K kernel {k9} launches")
        _check_api_rows(name, card, host)
        unplanted = [pl for pl in got if pl not in planted]
        missed = sorted(s for pl, s in planted.items()
                        if s >= min_snr and pl not in got)
        if unplanted or missed:
            raise RuntimeError(f"{name}: {len(unplanted)} unplanted decodes,"
                               f" planted signals missed at {missed} dB")
        if name in RETRY_RUNS and not {
                r.message.payload for r in out["DEEP"]} <= set(got):
            raise RuntimeError(f"{name}: lost a payload that DEEP decodes")
        if (name == "STANDARD" and buried in got) \
                or (name == "passes=2" and buried not in got):
            raise RuntimeError(f"{name}: the buried signal "
                               f"{'decoded' if buried in got else 'missed'}")
        out[name] = card
        lines.append(f"{name}: {len(card)} rows, all planted >= {min_snr:g} "
                     f"dB decoded (weakest decoded "
                     f"{min(planted[pl] for pl in got):.1f} dB), sync kernel "
                     f"launches {k6}, top-K kernel launches {k9}, OSD kernel "
                     f"launches {k4}, LLR kernel "
                     f"launches {k8}, BP + CRC kernel launches {k7}, first "
                     f"call {card_s * 1e3:.0f} ms")
    # osr 10x10 (the generic sync instance on a shrunk tile; the plain
    # waterfall, as at every osr of this API) on a band around the
    # strongest signal, so that the CPU side stays short
    strong = int(np.argmax(snr[:CROWD_SIGNALS]))
    band = dict(bins_per_tone=HIGH_OSR, steps_per_symbol=HIGH_OSR,
                freq_min=float(f0[strong]) - HIGH_OSR_BAND_HZ / 2,
                freq_max=float(f0[strong]) + HIGH_OSR_BAND_HZ / 2)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    card = decode_ft8_message(wave, FS, device=dev, **band)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    k6 = _counter("k6.launches")
    k7 = _counter("k7.launches")
    k8 = _counter("k8.launches")
    k9 = _counter("k9.launches")
    k6_total += k6
    t0 = time.perf_counter()
    host = decode_ft8_message(wave, FS, device="cpu", **band)
    host_s = time.perf_counter() - t0
    if k6 != 1 or k7 < 1 or k8 != 1 or k9 != 1 \
            or bytes(payloads[strong]) not in {
                r.message.payload for r in card}:
        raise RuntimeError(f"osr {HIGH_OSR}x{HIGH_OSR}: sync / BP + CRC / "
                           f"LLR / top-K kernel launches {k6} / {k7} / {k8} /"
                           f" {k9}, rows {card}")
    _check_api_rows(f"osr {HIGH_OSR}x{HIGH_OSR}", card, host)
    lines.append(f"osr {HIGH_OSR}x{HIGH_OSR} on {band['freq_min']:.0f}-"
                 f"{band['freq_max']:.0f} Hz: {len(card)} rows (the "
                 f"{snr[strong]:.1f} dB signal decoded), sync kernel "
                 f"launches {k6}, top-K kernel launches {k9}, LLR kernel "
                 f"launches {k8}, BP + CRC kernel "
                 f"launches {k7}, first call "
                 f"{card_s * 1e3:.0f} ms (CPU "
                 f"{host_s * 1e3:.0f} ms)")
    _phase(12, f"decode_ft8_message on a crowded {FS / 1000:g} kHz capture "
               f"({CROWD_SIGNALS} + 1 buried signals): "
               + "; ".join(lines) + "; card == CPU rows in every run; the "
               "buried signal decodes in the second pass only; every retry "
               "run decodes what DEEP decodes")
    return k6_total + _weak_phase(dev), out


def _weak_capture():
    """One 15-s 12 kHz capture from numpy.random.default_rng(WEAK_SEED):
    the WEAK_MESSAGES (packed by the port's codec) at SNRs spread evenly
    over WEAK_SNR_DB (2500-Hz convention, unit noise), off the search grid
    in time and frequency: 400-2600 Hz, >= 150 Hz apart, starting in
    0.2-1.2 s.  Returns (wave (n,) float32, payloads (6, 10), snr_db)."""
    from ft8_demodulator_tpu_torch.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu_torch.protocol import constants as C
    from ft8_demodulator_tpu_torch.protocol.encode import encode_tones
    from ft8_demodulator_tpu_torch.protocol.message import pack_message

    rng = np.random.default_rng(WEAK_SEED)
    n = int(FS * SLOT_S)
    sps = int(C.SYMBOL_PERIOD_S * FS)
    count = len(WEAK_MESSAGES)
    while True:
        f0 = np.sort(rng.uniform(400.0, 2600.0, count))
        if np.diff(f0).min() >= 150.0:
            break
    snr = rng.permutation(np.linspace(*WEAK_SNR_DB, count))
    starts = (rng.uniform(0.2, 1.2, count) * FS).astype(int)
    payloads = np.stack([pack_message(m) for m in WEAK_MESSAGES])
    wave = rng.standard_normal(n)
    tones = encode_tones(torch.as_tensor(payloads))
    for i in range(count):
        sig = _baseband_complex(tones[i], sps, FS, float(f0[i])).real.numpy()
        amp = np.sqrt(2.0 * 10.0 ** (snr[i] / 10.0) * 2500.0 / (FS / 2.0))
        wave[starts[i]: starts[i] + len(sig)] += amp * sig
    return wave.astype(np.float32), payloads, snr


def _weak_phase(dev) -> int:
    """Phase 12, second part: decode_ft8_message on the weak capture (DEEP
    and the coherent and a-priori retries; card rows == CPU rows, nothing
    unplanted, at least one payload beyond DEEP), then decode_slot on it as
    one slot with mf_refine, mf_first + mf_refine and coherent (card ==
    CPU).  Returns the frequency-major sync kernel's launches."""
    from ft8_demodulator_tpu_torch.demod.decode import (decode_ft8_message,
                                                        decode_slot)
    from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

    wave, payloads, snr = _weak_capture()
    planted = {bytes(pl): float(s) for pl, s in zip(payloads, snr)}
    k6_total, found, lines = 0, {}, []
    for name, extra in WEAK_RUNS.items():
        kw = dict(DEEP_API, **extra)
        torch.cuda.synchronize()
        _reset_counts()
        card = decode_ft8_message(wave, FS, device=dev, **kw)
        torch.cuda.synchronize()
        k6, k4, k7, k8, k9 = (_counter(f"{k}.launches")
                              for k in ("k6", "k4", "k7", "k8", "k9"))
        k6_total += k6
        if k6 < 1 or k4 < 1 or k7 < 1 \
                or k8 != _k8_want(k6, kw.get("mf_first", False)) \
                or k9 != k6:
            raise RuntimeError(f"weak capture, {name}: sync kernel {k6}, "
                               f"OSD kernel {k4}, BP + CRC kernel {k7}, LLR "
                               f"kernel {k8}, top-K kernel {k9} launches")
        _check_api_rows(f"weak capture, {name}", card,
                        decode_ft8_message(wave, FS, device="cpu", **kw))
        found[name] = {r.message.payload for r in card}
        if not found[name] <= set(planted) \
                or not found["DEEP"] <= found[name]:
            raise RuntimeError(f"weak capture, {name}: decoded "
                               f"{sorted(found[name])}, DEEP "
                               f"{sorted(found['DEEP'])}")
        lines.append(f"{name} " + ", ".join(
            f"{planted[pl]:.1f} dB" for pl in sorted(found[name],
                                                     key=planted.get)))
    beyond = {name: sorted(planted[pl] for pl in got - found["DEEP"])
              for name, got in found.items() if name != "DEEP"}
    if not any(beyond.values()):
        raise RuntimeError(f"weak capture: no retry decodes beyond DEEP "
                           f"({lines})")
    _phase(12, f"weak off-grid CQ capture ({len(planted)} signals at "
               f"{WEAK_SNR_DB[0]:g}..{WEAK_SNR_DB[1]:g} dB): decoded "
               + "; ".join(lines) + "; beyond DEEP: "
               + ", ".join(f"{name} {v}" for name, v in beyond.items())
               + "; card == CPU rows in every run")

    p = waterfall_params(FS, *DEEP_OSR)
    nf = p.num_frames(wave.shape[0])
    slot_kw = dict(max_candidates=DEEP_CANDIDATES, min_score=DEEP_MIN_SCORE,
                   max_iterations=BP_ITERATIONS, use_osd=True)
    slot_lines = []
    # (name, options, kernels that must launch, K8 launches: one on the
    # time-major routes, none on the frequency-major matched-filter route)
    for name, extra, used, k8_want in (
            ("use_mf + mf_refine", dict(use_mf=True, mf_refine=True),
             ("K1", "K5", "K8", "K4", "K7"), 1),
            ("mf_first + mf_refine", dict(mf_first=True, mf_refine=True),
             ("K6", "K4", "K7"), 0),
            ("mf_first + coherent", dict(mf_first=True, coherent=True),
             ("K3", "K5", "K8", "K4", "K7"), 1)):
        torch.cuda.synchronize()
        _reset_counts()
        card = decode_slot(torch.as_tensor(wave, device=dev), p, nf,
                           **slot_kw, **extra)
        torch.cuda.synchronize()
        launched = {k: _counter(f"{k.lower()}.launches")
                    for k in ("K1", "K3", "K5", "K6", "K8", "K9", "K4",
                              "K7")}
        k6_total += launched["K6"]
        if not all(launched[k] >= 1 for k in used) \
                or launched["K8"] != k8_want or launched["K9"] != 1:
            raise RuntimeError(f"decode_slot {name}: launches {launched}")
        lift = lambda r: type(r)(*(a[None] for a in r))
        sets = _decode_sets(lift(card), 1)
        host = _decode_sets(lift(decode_slot(
            torch.as_tensor(wave), p, nf, **slot_kw, **extra)), 1)
        if sets != host or not {s[0] for s in sets[0]} <= set(planted):
            raise RuntimeError(f"decode_slot {name}: card {sorted(sets[0])},"
                               f" CPU {sorted(host[0])}")
        slot_lines.append(f"{name} {len(sets[0])} decodes (launches "
                          + ", ".join(f"{k} {launched[k]}" for k in used)
                          + ")")
    _phase(12, "decode_slot on the weak capture as one slot (osr 4x4, K "
               f"{DEEP_CANDIDATES}, OSD): " + "; ".join(slot_lines)
               + "; card == CPU decode sets in each")
    return k6_total


def _stage_split(fn) -> dict[str, tuple[float, float]]:
    """One warm call of ``fn`` (a decode) under torch.profiler, split by
    the decoders' ``ft8.<stage>`` record_function ranges: {stage: (host ms
    inside its ranges but outside the ranges nested in them, device busy
    ms of the work launched inside them and not inside a nested range)}.
    "other" is device work launched outside every range; "call" the host
    extent of the traced call's ops and all its device busy ms.  A device
    event is placed by the host time of its launch (runtime or driver call,
    by correlation id; else the host op of its external id); one whose
    launch the trace lacks goes to "unplaced"."""
    fn()
    torch.cuda.synchronize()
    events = _trace_events(fn, 1)
    host_ops = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                for e in events if e.get("ph") == "X" and e.get("cat") in (
                    "cpu_op", "user_annotation", "cuda_runtime",
                    "cuda_driver")]
    call_ms = (max(hi for _, hi in host_ops)
               - min(lo for lo, _ in host_ops)) / 1e3
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"][4:]) for e in events
                    if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith("ft8."))
    launched, ext = {}, {}
    for e in events:
        args = e.get("args") or {}
        if e.get("cat") in ("cuda_runtime", "cuda_driver") \
                and "correlation" in args:
            launched[args["correlation"]] = float(e["ts"])
        elif e.get("cat") in ("cpu_op", "user_annotation") \
                and "External id" in args:
            ext[args["External id"]] = float(e["ts"])
    device = _device_events(events)
    by_stage: dict[str, list[dict]] = {}
    for e in device:
        args = e.get("args") or {}
        t = launched.get(args.get("correlation"),
                         ext.get(args.get("External id")))
        stage = "unplaced" if t is None else "other"
        inside = [r for r in ranges if t is not None and r[0] <= t <= r[1]]
        if inside:
            stage = max(inside)[2]              # the innermost range
        by_stage.setdefault(stage, []).append(e)
    host: dict[str, float] = {}
    for lo, hi, stage in ranges:
        inner = [(a, b) for a, b, _ in ranges
                 if lo <= a and b <= hi and (a, b) != (lo, hi)]
        nested = sum(b - a for a, b in inner
                     if not any(c <= a and b <= d and (c, d) != (a, b)
                                for c, d in inner))
        host[stage] = host.get(stage, 0.0) + (hi - lo - nested) / 1e3
    split = {stage: (host.get(stage, 0.0), _busy_ms(by_stage.get(stage, [])))
             for stage in dict.fromkeys([r[2] for r in ranges] + ["other"]
                                        + list(by_stage))}
    split["call"] = (call_ms, _busy_ms(device))
    return split


def _median_split(fn, reps: int) -> dict[str, tuple[float, float]]:
    """Per stage the medians of host and device ms over ``reps`` traces."""
    runs = [_stage_split(fn) for _ in range(reps)]
    keys = dict.fromkeys(k for r in runs for k in r)
    mid = lambda xs: sorted(xs)[len(xs) // 2]
    return {k: (mid([r.get(k, (0.0, 0.0))[0] for r in runs]),
                mid([r.get(k, (0.0, 0.0))[1] for r in runs])) for k in keys}


def _split_text(split: dict[str, tuple[float, float]]) -> str:
    return ", ".join(f"{k} {h:.2f}/{d:.2f}" for k, (h, d) in split.items())


def _median_ms(fn, reps: int) -> float:
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return sorted(runs)[len(runs) // 2]


def _time_phase(dev, smi: str, chunks, captures, waves) -> dict:
    """Phase 13: the sync kernels' device time against their plain
    versions, decode_ft8_message per capture (whole, and split by stage
    from profiler traces) and the decode_slots stage split.  Returns the
    kernel times."""
    from ft8_demodulator_tpu_torch.demod.decode import (decode_ft8_message,
                                                        decode_slots)
    from ft8_demodulator_tpu_torch.ops import sync as so
    from ft8_demodulator_tpu_torch.ops import sync_cuda as sc
    from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

    kt = {}
    for (grid, g), key, kernel, plain in (
            [(c, f"K5 {label}", sc.sync_scores_tf_kernel, so.sync_scores_tf)
             for c, label in zip(chunks, ("STANDARD", "DEEP"))]
            + [(c, f"K6 {label}", sc.sync_scores_kernel, so.sync_scores)
               for c, label in zip(captures, ("STANDARD", "DEEP"))]):
        ms, plain_ms, ev, _ = _kernel_vs_plain_ms(
            lambda: kernel(grid, g), lambda: plain(grid, g), "sync_kernel",
            plain_reps=5)
        # the grid in, the scores out; the adds as single FP32 instructions
        cells = kernel(grid, g).numel()
        kt[key] = (ms, plain_ms, ev, _bound(
            _sync_adds(g, cells, grid.numel()), 4 * (grid.numel() + cells),
            PEAK_F32_INSTR))

    wave = _crowded_capture()[0]
    api = {}
    for name in ("STANDARD", "DEEP"):
        kw = API_RUNS[name][0]
        if name == "DEEP":
            torch.cuda.reset_peak_memory_stats()
        call = lambda: decode_ft8_message(wave, FS, device=dev, **kw)
        api[name] = (_median_ms(call, API_REPS), _median_split(call, 3))
    api_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    # the deep retries: ms per capture of DEEP plus each, and the deepest
    # stack's split and peak memory
    retry_ms = {name: _median_ms(lambda: decode_ft8_message(
        wave, FS, device=dev, **API_RUNS[name][0]), API_REPS)
        for name in RETRY_RUNS}
    torch.cuda.reset_peak_memory_stats()
    call = lambda: decode_ft8_message(wave, FS, device=dev, **DEEPEST)
    api["deepest"] = (_median_ms(call, API_REPS), _median_split(call, 3))
    deepest_peak = torch.cuda.max_memory_allocated() / 2 ** 20

    slots = {}
    n = waves.shape[1]
    for name, osr, kw in (
            ("STANDARD", 2, dict(max_candidates=MAX_CANDIDATES,
                                 min_score=MIN_SCORE, chunk=CHUNK)),
            ("DEEP", 4, dict(max_candidates=DEEP_CANDIDATES,
                             min_score=DEEP_MIN_SCORE, chunk=DEEP_CHUNK,
                             use_osd=True, mf_first=True))):
        p = waterfall_params(FS, osr, osr)
        slots[name] = _stage_split(lambda: decode_slots(
            waves, p, p.num_frames(n), max_iterations=BP_ITERATIONS,
            bp_chunk=BP_CHUNK, **kw))

    _phase(13, f"[{smi}] sync kernels, device time (min of 2 windows): "
               + ", ".join(f"{key} kernel {a:.4f} ms (bound {bd[0]:.4f} ms "
                           f"by {bd[1]}) vs plain {b:.4f} ms ({ev} device "
                           f"events per plain call)"
                           for key, (a, b, ev, bd) in kt.items())
               + " (K5 per decode_slots chunk of 16 / 8 slots, K6 per "
               "capture); profiler windows taken again: "
               + (", ".join(_RETAKEN) or "none")
               + "; hand-kernel windows counted with a call lost: "
               + (", ".join(_SHORT) or "none")
               + f"; decode_ft8_message per capture, median of {API_REPS}: "
               + "; ".join(
                   f"{name} {whole:.1f} ms (stages from profiler traces, "
                   f"host/device ms, median of 3: {_split_text(split)})"
                   for name, (whole, split) in api.items())
               + f", DEEP peak memory {api_peak:.1f} MiB; DEEP plus each "
               f"retry, median of {API_REPS}: "
               + ", ".join(f"{k} {v:.1f} ms" for k, v in retry_ms.items())
               + f"; deepest stack (DEEP + mf_refine + coherent + ap "
               f"'{AP_CALLS}') peak memory {deepest_peak:.1f} MiB; "
               "decode_slots "
               f"batch {BATCH} stages (one profiled call, host/device ms; "
               "decode is BP + CRC, osd the ft8.osd range inside it): "
               + "; ".join(f"{name} {_split_text(st)}"
                           for name, st in slots.items()))
    return kt


# the beacon path (phase 14): BEACON_REPEATS 15-s cycles of 12-kHz audio,
# each holding the beacon at BEACON_F0 drifting BEACON_DRIFT Hz/s from its
# cycle's start at BEACON_SNR_DB (2500-Hz convention over unit noise),
# then 0.9 of a cycle holding another transmission at BEACON_TAIL_SNR_DB
# for the flush.  The SNR and seed were chosen with a CPU run of the port:
# no raw cycle decodes alone and the session first decodes the beacon with
# two cycles in its ring
BEACON_FS = 12000.0
BEACON_REPEATS = 8
BEACON_SNR_DB = -11.0
BEACON_DRIFT = 3.0
BEACON_F0 = 1500.0
BEACON_START_S = 0.5
BEACON_SEED = 1
BEACON_PAYLOAD = np.array([0x1C, 0x3F, 0x8A, 0x6A, 0xE2, 0x07, 0xA1, 0xE3,
                           0x94, 0x50], dtype=np.uint8)
BEACON_TAIL = "CQ K1ABC FN42"
BEACON_TAIL_F0 = 1000.0
BEACON_TAIL_SNR_DB = -3.0
BEACON_FEED = 50001              # samples a feed: cycles end mid-feed
BEACON_SESSION = dict(max_repeats=BEACON_REPEATS, use_osd=True,
                      coherent=True, correction=True, refine_fixes=True)
BEACON_DECODE = dict(use_osd=True, coherent=True, refine_fixes=True)
# card rows against CPU rows
BEACON_TIME_ATOL = 1e-3
BEACON_FREQ_ATOL = 0.01
BEACON_SNR_ATOL = 0.1
# known-payload detection and tracking, card against CPU
Z_RTOL = 1e-5
TRACK_STAT_ATOL = 0.02
TRACK_TIME_ATOL = 1e-4
TRACK_FREQ_ATOL = 0.01
# the waterfall backends, card against CPU (dB, above NULL_DB)
BACKEND_ATOL_DB = 1e-3
# the stacking results' geometry: 2 kHz, R = 8, no drift
STACK2K_SNR_DB = -22.0
BEACON_REPS = 3


def _amplitude(snr_db: float, fs: float) -> float:
    """Peak amplitude of a unit-power-baseband transmission at ``snr_db``
    in 2500 Hz over unit-variance white noise at ``fs``."""
    return float(np.sqrt(2.0 * 10.0 ** (snr_db / 10.0) * 2500.0
                         / (fs / 2.0)))


def _beacon_stream():
    """(the stream (8.9 cycles) float32, the BEACON_REPEATS raw cycles,
    the beacon's payload bytes, the tail's payload bytes)."""
    from ft8_demodulator_tpu_torch.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu_torch.protocol import constants as C
    from ft8_demodulator_tpu_torch.protocol.encode import encode_tones
    from ft8_demodulator_tpu_torch.protocol.message import pack_message

    fs = BEACON_FS
    n = int(fs * SLOT_S)
    sps = int(C.SYMBOL_PERIOD_S * fs)
    start = int(BEACON_START_S * fs)
    tail_payload = pack_message(BEACON_TAIL)
    tones = encode_tones(torch.as_tensor(np.stack([BEACON_PAYLOAD,
                                                   tail_payload])))
    bb = _baseband_complex(tones[0], sps, fs, BEACON_F0).numpy().astype(
        np.complex128)
    t = (start + np.arange(len(bb))) / fs
    one = np.zeros(n)
    one[start: start + len(bb)] = (bb * np.exp(1j * np.pi * BEACON_DRIFT
                                               * t * t)).real
    cycles = []
    for c in range(BEACON_REPEATS):
        rng = np.random.default_rng(BEACON_SEED * 100 + c)
        cycles.append((_amplitude(BEACON_SNR_DB, fs) * one
                       + rng.standard_normal(n)).astype(np.float32))
    rng = np.random.default_rng(BEACON_SEED * 100 + BEACON_REPEATS)
    tail = rng.standard_normal(int(0.9 * n))
    other = _baseband_complex(tones[1], sps, fs, BEACON_TAIL_F0).real.numpy()
    tail[start: start + len(other)] += _amplitude(BEACON_TAIL_SNR_DB,
                                                  fs) * other
    stream = np.concatenate(cycles + [tail.astype(np.float32)])
    return stream, cycles, BEACON_PAYLOAD.tobytes(), bytes(tail_payload)


def _feed_all(session, samples) -> tuple[list, int | None]:
    """Feed ``samples`` in BEACON_FEED-sample feeds: (rows, the ring depth
    at the feed that first reported BEACON_PAYLOAD)."""
    rows, first_at = [], None
    for i in range(0, len(samples), BEACON_FEED):
        got = session.feed(samples[i: i + BEACON_FEED])
        if first_at is None and BEACON_PAYLOAD.tobytes() in {
                r.message.payload for r in got}:
            first_at = session.repeats_buffered
        rows += got
    return rows, first_at


def _check_beacon_rows(name: str, card, host) -> None:
    """Card rows against CPU rows: the same payloads in order, times within
    BEACON_TIME_ATOL, frequencies within BEACON_FREQ_ATOL, SNRs within
    BEACON_SNR_ATOL."""
    def text(rows):
        return [(r.message.payload.hex(), r.time_sec, r.freq_hz, r.snr_db)
                for r in rows]

    if [r.message.payload for r in card] != [r.message.payload
                                              for r in host] \
            or any(abs(a.time_sec - b.time_sec) > BEACON_TIME_ATOL
                   or abs(a.freq_hz - b.freq_hz) > BEACON_FREQ_ATOL
                   or abs(a.snr_db - b.snr_db) > BEACON_SNR_ATOL
                   for a, b in zip(card, host)):
        raise RuntimeError(f"{name}: card rows {text(card)} != CPU rows "
                           f"{text(host)}")


def _backend_phase(dev) -> str:
    """Phase 14, part 1: waterfall_complex (block, 12 kHz), the matmul
    backend (1,999 Hz) and the fft backend (32,768 and 48,000 Hz) on the
    card against the CPU."""
    from ft8_demodulator_tpu_torch.ops import waterfall as twf

    texts = []
    rng = np.random.default_rng(14)
    for fs, complex_in, want in ((12000.0, True, "block"),
                                 (1999.0, False, "matmul"),
                                 (1999.0, True, "matmul"),
                                 (32768.0, True, "fft"),
                                 (48000.0, False, "fft")):
        p = twf.waterfall_params(fs, 2, 2)
        n = int(fs * SLOT_S)
        nf = p.num_frames(n)
        if twf._pick_backend(p, None) != want:
            raise RuntimeError(f"{fs} Hz picks {twf._pick_backend(p, None)}"
                               f", want {want}")
        shape = (n, 2) if complex_in else (n,)
        w = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
        fn = twf.waterfall_complex if complex_in else twf.waterfall_real
        card = fn(w.to(dev), p, nf).cpu()
        host = fn(w, p, nf)
        keep = host > NULL_DB
        err = float((card - host).abs()[keep].max())
        if card.shape != (p.num_freq_bins, nf) \
                or not bool(torch.isfinite(card).all()) \
                or not err <= BACKEND_ATOL_DB:
            raise RuntimeError(f"{want} at {fs} Hz: card vs CPU {err} dB "
                               f"(bound {BACKEND_ATOL_DB}), shape "
                               f"{tuple(card.shape)}")
        texts.append(f"{want} {'complex' if complex_in else 'real'} "
                     f"{fs / 1000:g} kHz ({p.num_freq_bins}x{nf}) "
                     f"{err:.2e} dB")
    return ", ".join(texts)


def _beacon_phase(dev, smi: str) -> tuple[int, int]:
    """Phase 14: the beacon receiver on the card.  Returns the OSD and the
    frequency-major sync kernels' launches on its paths."""
    import scipy.signal

    from ft8_demodulator_tpu_torch.beacon import (correct_frequency_drift,
                                                  detect_known_payload,
                                                  track_known_payload)
    from ft8_demodulator_tpu_torch.demod import (BeaconSession,
                                                 decode_ft8_message,
                                                 decode_ft8_stacked)

    fs = BEACON_FS
    n = int(fs * SLOT_S)
    _phase(14, "waterfall backends, card vs CPU, max |diff| above "
               f"{NULL_DB:g} dB: {_backend_phase(dev)} (bound "
               f"{BACKEND_ATOL_DB})")

    # a single raw cycle misses the beacon
    stream, cycles, beacon, tail = _beacon_stream()
    single = [beacon in {r.message.payload for r in decode_ft8_message(
        c, fs, device=dev)} for c in cycles]
    single_cpu = beacon in {r.message.payload for r in decode_ft8_message(
        cycles[0], fs, device="cpu")}
    if any(single) or single_cpu:
        raise RuntimeError(f"a single raw cycle decodes the beacon: card "
                           f"{single}, CPU cycle 0 {single_cpu}")

    # the session on the card: the counts from 0 just before, read after
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    card_s = BeaconSession(fs, device=dev, **BEACON_SESSION)
    card, first_at = _feed_all(card_s, stream)
    torch.cuda.synchronize()
    k4_feed = _counter("k4.launches")
    k6_feed = _counter("k6.launches")
    k7_feed = _counter("k7.launches")
    k9_feed = _counter("k9.launches")
    _reset_counts()
    flushed = card_s.flush()
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    k6_flush = _counter("k6.launches")
    k7_flush = _counter("k7.launches")
    k9_flush = _counter("k9.launches")
    card += flushed
    t0 = time.perf_counter()
    host_s = BeaconSession(fs, device="cpu", **BEACON_SESSION)
    host, host_first = _feed_all(host_s, stream)
    host += host_s.flush()
    host_ms = (time.perf_counter() - t0) * 1e3
    _check_beacon_rows("BeaconSession", card, host)
    payloads = [r.message.payload for r in card]
    if payloads.count(beacon) != 1 or first_at != host_first \
            or first_at is None or first_at < 2 \
            or tail not in {r.message.payload for r in flushed}:
        raise RuntimeError(f"BeaconSession: beacon reported "
                           f"{payloads.count(beacon)} times, first at ring "
                           f"depth {first_at} (CPU {host_first}); flushed "
                           f"{[r.message.payload for r in flushed]}")
    if k4_feed < 1 or k6_feed != 0 or k6_flush < 1 or k7_feed < 1 \
            or k7_flush < 1 or k9_feed < 1 or k9_flush < k6_flush:
        raise RuntimeError(f"BeaconSession: OSD kernel {k4_feed} launches in"
                           f" the stacked decodes, sync kernel {k6_feed} in "
                           f"them and {k6_flush} in the flush, BP + CRC "
                           f"kernel {k7_feed} / {k7_flush}, top-K kernel "
                           f"{k9_feed} / {k9_flush}")
    # save / load mid-stream resumes with the same rows
    cut = int(4.5 * n)
    first = BeaconSession(fs, device=dev, **BEACON_SESSION)
    rows = _feed_all(first, stream[:cut])[0]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "session.npz")
        first.save(path)
        resumed = BeaconSession.load(path, device=dev)
    rows += _feed_all(resumed, stream[cut:])[0] + resumed.flush()
    key = lambda rs: [(r.message.payload, r.time_sec, r.freq_hz, r.snr_db)
                      for r in rs]
    if key(rows) != key(card):
        raise RuntimeError(f"save/load: resumed rows {key(rows)} != "
                           f"{key(card)}")
    beacon_row = card[payloads.index(beacon)]
    # what the blind corrector fits on each raw cycle at this SNR
    rates = [correct_frequency_drift(
        scipy.signal.hilbert(c.astype(np.float64)), fs, return_model=True,
        device=dev)[2]["rate_hz_per_s"] for c in cycles]
    _phase(14, f"BeaconSession at {fs / 1000:g} kHz (max_repeats "
               f"{BEACON_REPEATS}, OSD, coherent, correction, refine_fixes) "
               f"on {BEACON_REPEATS} cycles of a beacon drifting "
               f"{BEACON_DRIFT:g} Hz/s at {BEACON_SNR_DB:g} dB plus a "
               f"{BEACON_TAIL_SNR_DB:g} dB tail, fed {BEACON_FEED} samples at"
               f" a time: no raw cycle decodes alone (decode_ft8_message, "
               f"card; cycle 0 on the CPU too); the beacon reported once, "
               f"first at ring depth {first_at} (t {beacon_row.time_sec} s, "
               f"f {beacon_row.freq_hz} Hz, SNR {beacon_row.snr_db} dB), the "
               f"tail's payload by the flush; card == CPU rows ({len(card)}); "
               f"OSD kernel launches in the stacked decodes {k4_feed}, sync "
               f"kernel launches {k6_feed} there and {k6_flush} in the "
               f"flush, BP + CRC kernel launches {k7_feed} there and "
               f"{k7_flush} in the flush, top-K kernel launches {k9_feed} "
               f"there and {k9_flush} in the flush; save/load after 4.5 "
               f"cycles "
               f"resumes with the same "
               f"rows; whole stream card {card_ms:.0f} ms, CPU "
               f"{host_ms:.0f} ms; correct_frequency_drift's fitted rate "
               f"per raw cycle (Hz/s, {BEACON_DRIFT:g} injected): "
               + ", ".join("none" if r is None else f"{r:.2f}"
                           for r in rates))

    # known-payload detection and tracking on the same captures: R = 1 on
    # a raw cycle, R = 8 on the CPU session's corrected cycles
    corrected = np.stack(host_s._cycles)
    det = {}
    for label, waves in (("R1", cycles[0]), ("R8", corrected)):
        got = [detect_known_payload(waves, fs, BEACON_PAYLOAD, top_k=4,
                                    min_z=-100.0, device=d)
               for d in (dev, "cpu")]
        if [(x.time_sec, x.freq_hz) for x in got[0]] != \
                [(x.time_sec, x.freq_hz) for x in got[1]] \
                or any(abs(a.z - b.z) > Z_RTOL * abs(b.z)
                       for a, b in zip(*got)):
            raise RuntimeError(f"detect_known_payload {label}: card "
                               f"{got[0]}, CPU {got[1]}")
        det[label] = got[0][0]
    hint = det["R8"]
    fixes = [track_known_payload(corrected[-1], fs, BEACON_PAYLOAD,
                                 hint.time_sec, hint.freq_hz, device=d)
             for d in (dev, "cpu")]
    a, b = fixes
    if a.detected != b.detected or abs(a.stat - b.stat) > TRACK_STAT_ATOL \
            or abs(a.time_sec - b.time_sec) > TRACK_TIME_ATOL \
            or abs(a.freq_hz - b.freq_hz) > TRACK_FREQ_ATOL:
        raise RuntimeError(f"track_known_payload: card {a}, CPU {b}")
    _phase(14, "known payload, card == CPU: detect_known_payload top "
               + ", ".join(f"{k} z {v.z:.2f} at {v.time_sec:.3f} s "
                           f"{v.freq_hz:.3f} Hz" for k, v in det.items())
               + f"; track_known_payload on the newest corrected cycle: "
               f"detected {a.detected}, stat {a.stat}, {a.time_sec} s, "
               f"{a.freq_hz} Hz")

    # complex and non-block decodes of phase 12's crowded capture
    wave, cpayloads, csnr, _ = _crowded_capture()
    planted = {bytes(pl) for pl in cpayloads}
    analytic = scipy.signal.hilbert(wave.astype(np.float64)).astype(
        np.complex64)
    # a 48-kHz sound card: the capture resampled, and white noise over
    # the band above the capture's (in band +0.26 dB of noise)
    w48 = (scipy.signal.resample_poly(wave.astype(np.float64), 4, 1)
           + 0.5 * np.random.default_rng(48).standard_normal(4 * len(wave))
           ).astype(np.float32)
    k6_api, api_lines = 0, []
    for name, w, rate in (("analytic", analytic, FS), ("48 kHz", w48,
                                                       48000.0)):
        torch.cuda.synchronize()
        _reset_counts()
        got = decode_ft8_message(w, rate, device=dev)
        torch.cuda.synchronize()
        k6 = _counter("k6.launches")
        k7 = _counter("k7.launches")
        k9 = _counter("k9.launches")
        k6_api += k6
        _check_api_rows(f"decode_ft8_message {name}", got,
                        decode_ft8_message(w, rate, device="cpu"))
        found = {r.message.payload for r in got}
        if k6 < 1 or k7 < 1 or k9 != k6 or not found <= planted \
                or len(found) < CROWD_SIGNALS // 2:
            raise RuntimeError(f"decode_ft8_message {name}: sync / BP + CRC "
                               f"/ top-K kernel {k6} / {k7} / {k9} launches, "
                               f"{len(found)} payloads, "
                               f"{len(found - planted)} unplanted")
        api_lines.append(f"{name} {len(found)} planted payloads, sync "
                         f"kernel launches {k6}, top-K kernel launches {k9}, "
                         f"BP + CRC kernel launches {k7}")
    # the stacking results' geometry: R = 8 at 2 kHz
    w2k = np.stack([scipy.signal.resample_poly(c.astype(np.float64), 1, 6)
                    for c in _stack2k_cycles()]).astype(np.float32)
    torch.cuda.synchronize()
    _reset_counts()
    got = decode_ft8_stacked(w2k, 2000.0, device=dev, **BEACON_DECODE)
    torch.cuda.synchronize()
    k4_2k = _counter("k4.launches")
    k7_2k = _counter("k7.launches")
    k9_2k = _counter("k9.launches")
    _check_beacon_rows("decode_ft8_stacked 2 kHz R 8", got,
                       decode_ft8_stacked(w2k, 2000.0, device="cpu",
                                          **BEACON_DECODE))
    if k4_2k < 1 or k7_2k < 1 or k9_2k != 1:
        raise RuntimeError(f"decode_ft8_stacked 2 kHz: OSD / BP + CRC / "
                           f"top-K kernel {k4_2k} / {k7_2k} / {k9_2k}")
    verdict = "decoded" if beacon in {r.message.payload for r in got} \
        else "missed"
    _phase(14, "decode_ft8_message on phase 12's capture, card == CPU rows: "
               + "; ".join(api_lines) + f"; decode_ft8_stacked at 2 kHz, R "
               f"{BEACON_REPEATS}, {STACK2K_SNR_DB:g} dB, no drift: "
               f"{verdict}, card == CPU rows, OSD kernel launches {k4_2k}, "
               f"BP + CRC kernel launches {k7_2k}, top-K kernel launches "
               f"{k9_2k}")

    _beacon_times(dev, smi, cycles, corrected, analytic, w48, w2k)
    return k4_feed + k4_2k, k6_flush + k6_api


def _stack2k_cycles():
    """BEACON_REPEATS 12-kHz cycles of the beacon without drift at
    STACK2K_SNR_DB, noise from BEACON_SEED + 1 (resampled to 2 kHz by the
    caller)."""
    from ft8_demodulator_tpu_torch.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu_torch.protocol import constants as C
    from ft8_demodulator_tpu_torch.protocol.encode import encode_tones

    fs = BEACON_FS
    n = int(fs * SLOT_S)
    start = int(BEACON_START_S * fs)
    sig = _baseband_complex(encode_tones(torch.as_tensor(BEACON_PAYLOAD)),
                            int(C.SYMBOL_PERIOD_S * fs), fs,
                            400.0).real.numpy()
    out = []
    for c in range(BEACON_REPEATS):
        w = np.random.default_rng((BEACON_SEED + 1) * 100 + c
                                  ).standard_normal(n)
        w[start: start + len(sig)] += _amplitude(STACK2K_SNR_DB, fs) * sig
        out.append(w)
    return out


def _beacon_times(dev, smi: str, cycles, corrected, analytic, w48,
                  w2k) -> None:
    """Phase 14, times: ms per feed that completes a cycle (correction and
    an R = 8 decode with coherent and OSD), correct_frequency_drift per
    cycle, decode_ft8_stacked at R = 1, 4, 8, detect_known_payload at R = 8,
    the complex and 48-kHz decodes per capture, each with its stage split
    (ft8.<stage> ranges, host/device ms), and peak device memory."""
    import scipy.signal

    from ft8_demodulator_tpu_torch.beacon import (correct_frequency_drift,
                                                  detect_known_payload)
    from ft8_demodulator_tpu_torch.demod import (BeaconSession,
                                                 decode_ft8_message,
                                                 decode_ft8_stacked)

    fs = BEACON_FS
    session = BeaconSession(fs, device=dev, **BEACON_SESSION)
    for c in cycles:
        session.feed(c)
    turn = iter(range(10 ** 6))
    feed = lambda: session.feed(cycles[next(turn) % len(cycles)])
    torch.cuda.reset_peak_memory_stats()
    feed_ms = _median_ms(feed, BEACON_REPS)
    feed_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    runs = {"feed": (feed_ms, _median_split(feed, BEACON_REPS))}
    z = scipy.signal.hilbert(cycles[0].astype(np.float64))
    calls = {
        "correct_frequency_drift": lambda: correct_frequency_drift(
            z, fs, device=dev),
        **{f"decode_ft8_stacked R{r}": (
            lambda r=r: decode_ft8_stacked(corrected[-r:], fs, device=dev,
                                           **BEACON_DECODE))
           for r in (1, 4, BEACON_REPEATS)},
        "decode_ft8_stacked 2 kHz R8": lambda: decode_ft8_stacked(
            w2k, 2000.0, device=dev, **BEACON_DECODE),
        "detect_known_payload R8": lambda: detect_known_payload(
            corrected, fs, BEACON_PAYLOAD, device=dev),
        "decode_ft8_message analytic": lambda: decode_ft8_message(
            analytic, FS, device=dev),
        "decode_ft8_message 48 kHz": lambda: decode_ft8_message(
            w48, 48000.0, device=dev),
    }
    peaks = {}
    for name, fn in calls.items():
        torch.cuda.reset_peak_memory_stats()
        ms = _median_ms(fn, BEACON_REPS)
        peaks[name] = torch.cuda.max_memory_allocated() / 2 ** 20
        runs[name] = (ms, _median_split(fn, BEACON_REPS))
    _phase(14, f"[{smi}] times, median of {BEACON_REPS} (host ms to a "
               f"synchronize; stages from profiler traces, host/device ms, "
               f"median of {BEACON_REPS}): "
               + "; ".join(f"{name} {ms:.1f} ms ({_split_text(split)})"
                           for name, (ms, split) in runs.items())
               + f"; peak memory: feed {feed_peak:.1f} MiB, "
               + ", ".join(f"{k} {v:.1f} MiB" for k, v in peaks.items()))


# the satellite channel (phase 15): the demo's flow at its full size, 4
# cycles at 10 kHz through the predicted pass's Doppler at Es/N0 -14 dB,
# decimated to 2 kHz; the noise from a torch.Generator seeded by DEMO_SEED
# (the demo's default seed, not chosen)
DEMO_CYCLES = 4
DEMO_ESN0 = -14.0
DEMO_SEED = 0
DEMO_MESSAGE = "CQ PI4THD JO22"
DOPPLER_ATOL = 2e-5
AWGN_RTOL = 0.02
DEMO_REPS = 3


def _demo_rows_text(rows) -> list:
    return [(r.message.payload.hex(), r.time_sec, r.freq_hz, r.snr_db)
            for r in rows]


def _channel_phase(dev, smi: str) -> tuple[int, int]:
    """Phase 15: the Doppler ops and the noise on the card, then the demo's
    RX on one capture, card against CPU.  Returns the OSD and the
    frequency-major sync kernels' launches in the card's RX."""
    from ft8_demodulator_tpu_torch import channel as tch
    from ft8_demodulator_tpu_torch.examples import \
        satellite_beacon_demo as demo
    from ft8_demodulator_tpu_torch.protocol.message import unpack_message

    fs = demo.FS_RF
    doppler, info = demo.predict_pass_doppler(DEMO_CYCLES, fs)
    n = len(doppler)
    slope, intercept = np.polyfit(np.arange(n), doppler, 1)
    w = np.random.default_rng(15).standard_normal((n, 2)).astype(np.float32)
    errs, op_ms = {}, {}
    for name, args in (("apply_doppler", (doppler, fs)),
                       ("apply_doppler_physical", (doppler, fs)),
                       ("compensate_linear_doppler", (slope, intercept, fs)),
                       ("compensate_linear_doppler_physical",
                        (slope, intercept, fs))):
        fn = getattr(tch, name)
        card = fn(w, *args, device=dev)
        host = fn(w, *args, device="cpu")
        errs[name] = float((card.cpu() - host).abs().max())
        if card.shape != (n, 2) or not bool(torch.isfinite(card).all()) \
                or not errs[name] <= DOPPLER_ATOL:
            raise RuntimeError(f"{name} on the card: {errs[name]} off the "
                               f"CPU (bound {DOPPLER_ATOL})")
        wd = torch.as_tensor(w, device=dev)
        op_ms[name] = _median_ms(lambda: fn(wd, *args), DEMO_REPS)
    ratios = {}
    x = torch.as_tensor(w, device=dev)
    for snr in (10.0, DEMO_ESN0):
        noisy = tch.add_complex_awgn(x, torch.Generator().manual_seed(15),
                                     snr)
        p_sig = float((x ** 2).sum(-1).mean())
        p_noise = float(((noisy - x) ** 2).sum(-1).mean())
        ratios[snr] = p_noise / (2.0 * p_sig / 10.0 ** (snr / 10.0))
        if not abs(ratios[snr] - 1.0) <= AWGN_RTOL:
            raise RuntimeError(f"add_complex_awgn at {snr} dB: noise power "
                               f"{ratios[snr]} of its target")
    _phase(15, f"satellite channel on the predicted pass ({info}; "
               f"{doppler[0]:+.0f} -> {doppler[-1]:+.0f} Hz over {n} samples "
               f"at {fs / 1000:g} kHz): Doppler ops card vs CPU max |diff| "
               + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
               + f" (bound {DOPPLER_ATOL}); add_complex_awgn noise power / "
               "target " + ", ".join(f"{k:g} dB {v:.4f}"
                                     for k, v in ratios.items())
               + f" (bound {AWGN_RTOL})")

    # the demo: one capture (the card's), decoded by the card and the CPU
    noisy = demo.transmit(DEMO_CYCLES, DEMO_ESN0, DEMO_SEED, doppler,
                          device=dev)
    host_noisy = noisy.cpu()
    card_lines, host_lines = [], []
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    card = demo.receive(noisy, doppler, DEMO_CYCLES, device=dev,
                        out=card_lines.append)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    k4 = _counter("k4.launches")
    k6 = _counter("k6.launches")
    k7 = _counter("k7.launches")
    k9 = _counter("k9.launches")
    t0 = time.perf_counter()
    host = demo.receive(host_noisy, doppler, DEMO_CYCLES, device="cpu",
                        out=host_lines.append)
    host_ms = (time.perf_counter() - t0) * 1e3
    _check_beacon_rows("demo path A decode_ft8_message", card["single"],
                       host["single"])
    _check_beacon_rows("demo path B decode_ft8_stacked", card["rows"],
                       host["rows"])
    texts = [unpack_message(r.message.payload) for r in card["rows"]]
    det = card["dets"][0] if card["dets"] else None
    if DEMO_MESSAGE not in texts or det is None \
            or abs(det.time_sec) > 0.5 or abs(det.freq_hz - demo.F0_HZ) > 5.0:
        raise RuntimeError(f"demo: stacked decode {texts} (CPU "
                           f"{[unpack_message(r.message.payload) for r in host['rows']]}"
                           f"), detection {det} (CPU "
                           f"{host['dets'][:1]})")
    if k6 < 1 or k4 < 1 or k7 < 1 or k9 < k6:
        raise RuntimeError(f"demo RX: sync kernel {k6}, OSD kernel {k4}, "
                           f"BP + CRC kernel {k7}, top-K kernel {k9} "
                           "launches")
    _phase(15, f"demo at full size ({DEMO_CYCLES} cycles at {fs / 1000:g} "
               f"kHz, Es/N0 {DEMO_ESN0:g} dB, seed {DEMO_SEED}, decimated "
               f"x{demo.DECIM}): card == CPU rows, path A "
               f"{_demo_rows_text(card['single'])}, path B "
               f"{_demo_rows_text(card['rows'])}; card prints: "
               + " | ".join(card_lines) + f"; sync kernel launches {k6}, "
               f"top-K kernel launches {k9}, "
               f"OSD kernel launches {k4}, BP + CRC kernel launches {k7}; "
               f"RX card {card_ms:.0f} ms (first "
               f"call), CPU {host_ms:.0f} ms")

    tx_ms = _median_ms(lambda: demo.transmit(DEMO_CYCLES, DEMO_ESN0,
                                             DEMO_SEED, doppler, device=dev),
                       DEMO_REPS)
    rx = lambda: demo.receive(noisy, doppler, DEMO_CYCLES, device=dev,
                              out=lambda s: None)
    torch.cuda.reset_peak_memory_stats()
    rx_ms = _median_ms(rx, DEMO_REPS)
    rx_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    split = _median_split(rx, DEMO_REPS)
    _phase(15, f"[{smi}] times, median of {DEMO_REPS} (host ms to a "
               "synchronize): Doppler ops on the pass "
               + ", ".join(f"{k} {v:.2f} ms" for k, v in op_ms.items())
               + f"; TX + channel + noise {tx_ms:.1f} ms; RX (paths A and B,"
               f" detection, tracking) {rx_ms:.1f} ms ({_split_text(split)})"
               f"; RX peak memory {rx_peak:.1f} MiB")
    return k4, k6


# the streaming session (phase 16): 2 minutes of 12-kHz audio (unit white
# noise from default_rng(STREAM_SEED)) holding six transmissions at
# STREAM_SNR_DB (2500-Hz convention): one clipped at capture start, one
# across the first block edge, two in one slot 60 Hz apart, one more, and
# one in the final partial block (the flush's)
STREAM_FS = 12000.0
STREAM_SECONDS = 120
STREAM_SEED = 16
STREAM_SNR_DB = -6.0
STREAM_FEED = 50001              # samples a feed: blocks end mid-feed
STREAM_EVENTS = (("CQ K1ABC FN42", -1.0, 800.0),
                 ("CQ W9XYZ EN37", 13.5, 1500.0),
                 ("CQ DL1ABC JO62", 46.0, 1200.0),
                 ("CQ PI4THD JO22", 46.0, 1260.0),
                 ("CQ G4ABC IO91", 75.5, 2100.0),
                 ("CQ JA1XYZ PM95", 106.5, 600.0))
STREAM_BLOCKS = 8
STREAM_CUT_BLOCKS = 3.5
STREAM_TIME_ATOL = 0.2
STREAM_FREQ_ATOL = 4.0
STREAM_REPS = 5


def _stream_audio():
    """(audio float32, {payload: (text, start s, f0 Hz)})."""
    from ft8_demodulator_tpu_torch.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu_torch.protocol import constants as C
    from ft8_demodulator_tpu_torch.protocol.encode import encode_tones
    from ft8_demodulator_tpu_torch.protocol.message import pack_message

    fs = STREAM_FS
    n = int(STREAM_SECONDS * fs)
    sps = int(C.SYMBOL_PERIOD_S * fs)
    audio = np.random.default_rng(STREAM_SEED).standard_normal(n)
    planted = {}
    for text, t, f0 in STREAM_EVENTS:
        payload = pack_message(text)
        w = _baseband_complex(encode_tones(torch.as_tensor(payload)), sps,
                              fs, f0).real.numpy()
        i = int(round(t * fs))
        if i < 0:
            w, i = w[-i:], 0
        w = w[: n - i]
        audio[i: i + len(w)] += _amplitude(STREAM_SNR_DB, fs) * w
        planted[bytes(payload)] = (text, t, f0)
    return audio.astype(np.float32), planted


def _stream_feed(session, samples) -> list:
    rows = []
    for i in range(0, len(samples), STREAM_FEED):
        rows += session.feed(samples[i: i + STREAM_FEED])
    return rows


def _stream_phase(dev, smi: str) -> tuple[int, int]:
    """Phase 16: StreamSession on the card against the CPU.  Returns the
    OSD and the frequency-major sync kernels' launches in the card's
    sessions."""
    from ft8_demodulator_tpu_torch.config import DEEP_SEARCH, STANDARD
    from ft8_demodulator_tpu_torch.demod.stream_session import StreamSession

    fs = STREAM_FS
    audio, planted = _stream_audio()
    k4_total = k6_total = 0
    texts, times = [], []
    for name, cfg in (("STANDARD", STANDARD), ("DEEP", DEEP_SEARCH)):
        runs = {}
        for depth in (0, 2):
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            s = StreamSession(fs, cfg, pipeline_depth=depth, device=dev)
            rows = _stream_feed(s, audio) + s.flush()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            k4 = _counter("k4.launches")
            k6 = _counter("k6.launches")
            k7 = _counter("k7.launches")
            k8 = _counter("k8.launches")
            k9 = _counter("k9.launches")
            k4_total += k4
            k6_total += k6
            if k6 != STREAM_BLOCKS or (k4 > 0) != cfg.use_osd or k7 < 1 \
                    or k8 != _k8_want(k6, cfg.mf_first) or k9 != k6:
                raise RuntimeError(f"StreamSession {name} depth {depth}: "
                                   f"sync kernel {k6} launches (want one a "
                                   f"block, {STREAM_BLOCKS}), OSD kernel "
                                   f"{k4}, BP + CRC kernel {k7}, LLR kernel "
                                   f"{k8}, top-K kernel {k9}")
            runs[depth] = (rows, ms, k4, k6, k7, k8)
        card = runs[0][0]
        t0 = time.perf_counter()
        hs = StreamSession(fs, cfg, device="cpu")
        host = _stream_feed(hs, audio) + hs.flush()
        host_ms = (time.perf_counter() - t0) * 1e3
        _check_api_rows(f"StreamSession {name}", card, host)
        key = lambda rs: [(r.message.payload, r.time_sec, r.freq_hz, r.score,
                           r.snr_db) for r in rs]
        if key(runs[2][0]) != key(card):
            raise RuntimeError(f"StreamSession {name}: pipeline_depth 2 rows"
                               f" {key(runs[2][0])} != depth 0 {key(card)}")
        got = [r.message.payload for r in card]
        for payload, (text, t, f0) in planted.items():
            hit = [r for r in card if r.message.payload == payload]
            if len(hit) != 1 \
                    or abs(hit[0].time_sec - t) > STREAM_TIME_ATOL \
                    or abs(hit[0].freq_hz - f0) > STREAM_FREQ_ATOL:
                raise RuntimeError(f"StreamSession {name}: {text!r} at {t} s"
                                   f" {f0} Hz reported {len(hit)} times: "
                                   f"{_demo_rows_text(hit)}")
        if set(got) - set(planted):
            raise RuntimeError(f"StreamSession {name}: unplanted rows "
                               f"{set(got) - set(planted)}")
        # save after 3.5 blocks, with a block in flight at depth 2
        cut = int(STREAM_CUT_BLOCKS * SLOT_S * fs)
        first = StreamSession(fs, cfg, pipeline_depth=2, device=dev)
        rows = _stream_feed(first, audio[:cut])
        in_flight = len(first._pending)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "stream.npz")
            first.save(path)
            resumed = StreamSession.load(path, device=dev)
        rows += _stream_feed(resumed, audio[cut:]) + resumed.flush()
        if in_flight < 1 or key(rows) != key(card):
            raise RuntimeError(f"StreamSession {name}: {in_flight} blocks in "
                               f"flight at the save; resumed rows "
                               f"{key(rows)} != {key(card)}")
        texts.append(
            f"{name}: {len(card)} rows, each planted signal once, card == "
            f"CPU, depth 2 == depth 0, sync kernel launches "
            f"{runs[0][3]}/{runs[2][3]} (depth 0/2), OSD kernel launches "
            f"{runs[0][2]}/{runs[2][2]}, BP + CRC kernel launches "
            f"{runs[0][4]}/{runs[2][4]}, LLR kernel launches "
            f"{runs[0][5]}/{runs[2][5]}; save after {STREAM_CUT_BLOCKS:g} "
            f"blocks ({in_flight} in flight) resumes with the same rows; "
            f"whole stream card {runs[0][1]:.0f}/{runs[2][1]:.0f} ms (first"
            f" calls), CPU {host_ms:.0f} ms; rows "
            + ", ".join(f"{planted[r.message.payload][0]!r} {r.time_sec:.2f}"
                        f" s {r.freq_hz:.2f} Hz {r.snr_db:+.1f} dB"
                        for r in card))

        # a warm session, fed one block's samples at a time: each feed
        # completes a block
        s = StreamSession(fs, cfg, device=dev)
        s.feed(audio[: s.lookahead])
        turn = iter(range(10 ** 6))

        def feed(s=s, turn=turn):
            j = next(turn) % 6
            return s.feed(audio[j * s.block_len: (j + 1) * s.block_len])

        torch.cuda.reset_peak_memory_stats()
        feed_ms = _median_ms(feed, STREAM_REPS)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        split = _median_split(feed, 3)
        busy = split["call"][1]
        times.append(f"{name} {feed_ms:.1f} ms a feed, device busy "
                     f"{busy:.2f} ms ({100 * (1 - busy / feed_ms):.0f} % "
                     f"idle), peak {peak:.1f} MiB ({_split_text(split)})")
    _phase(16, f"StreamSession at {fs / 1000:g} kHz on {STREAM_SECONDS} s "
               f"({STREAM_BLOCKS} blocks) of audio with "
               f"{len(STREAM_EVENTS)} signals at {STREAM_SNR_DB:g} dB, fed "
               f"{STREAM_FEED} samples at a time: " + "; ".join(texts))
    _phase(16, f"[{smi}] a feed that completes a block, median of "
               f"{STREAM_REPS} (host ms to a synchronize; device busy and "
               "stages from profiler traces, host/device ms, median of 3): "
               + "; ".join(times))
    return k4_total, k6_total


# the CLI (phase 17): python -m ft8_demodulator_tpu_torch.cli in processes
# of its own, on the card and with FT8_PLATFORM=cpu
CLI_TX = "CQ K1ABC FN42"
CLI_TX_SNR = "-10"
CLI_TX_SEED = "17"
CLI_BEACON_SNR_DB = -20.0
CLI_BEACON_F0 = 1400.0
CLI_TIMEOUT_S = 300


def _cli_run(args: list[str], cpu: bool) -> tuple[str, float]:
    """(stdout, wall seconds) of one CLI process; a non-zero exit
    raises."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("FT8_PLATFORM", None)
    if cpu:
        env["FT8_PLATFORM"] = "cpu"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ft8_demodulator_tpu_torch.cli", *args],
        cwd=root, env=env, capture_output=True, text=True,
        timeout=CLI_TIMEOUT_S)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"cli {args} ({'CPU' if cpu else 'card'}) exit "
                           f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, secs


def _one_unit_apart(a, b, unit: float) -> bool:
    """Two printed numbers at most one unit of their last printed digit
    apart."""
    try:
        return abs(float(a) - float(b)) <= unit * (1 + 1e-6)
    except (TypeError, ValueError):
        return False


# the last printed digit of each number the CLI prints with a score or SNR
CLI_UNITS = {"Score: ": 0.1, "SNR: ": 0.1, "score": 0.01, "snr_db": 0.1}


def _cli_same(name: str, card: str, host: str) -> int:
    """The card's stdout against the CPU's: equal line for line, but for a
    printed score or SNR one unit of its last digit apart, the rest of the
    line equal (``--format json`` rows parsed).  Returns how many lines
    differ so."""
    a, b = card.splitlines(), host.splitlines()
    if len(a) != len(b):
        raise RuntimeError(f"cli {name}: card stdout {a} != CPU {b}")
    edges = 0
    for x, y in zip(a, b):
        if x == y:
            continue
        ok = False
        for label in ("Score: ", "SNR: "):
            if x.startswith(label) and y.startswith(label):
                u, v = x[len(label):].split(), y[len(label):].split()
                ok = u[1:] == v[1:] and _one_unit_apart(u[0], v[0],
                                                        CLI_UNITS[label])
        if x.startswith("{") and y.startswith("{"):
            p, q = json.loads(x), json.loads(y)
            rest = lambda r: {k: v for k, v in r.items()
                              if k not in ("score", "snr_db")}
            ok = rest(p) == rest(q) and all(
                _one_unit_apart(p[k], q[k], CLI_UNITS[k])
                for k in ("score", "snr_db"))
        if not ok:
            raise RuntimeError(f"cli {name}: card line {x!r} != CPU {y!r}")
        edges += 1
    return edges


def _cli_phase(dev, smi: str) -> tuple[int, int]:
    """Phase 17: the CLI in processes of its own, card against CPU, and
    its --deep decode once in this process with the launch counters.
    Returns the OSD and the frequency-major sync kernels' launches there."""
    import contextlib
    import io

    from ft8_demodulator_tpu_torch import cli
    from ft8_demodulator_tpu_torch.io import read_wave_file, write_wave_file
    from ft8_demodulator_tpu_torch.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu_torch.protocol import constants as C
    from ft8_demodulator_tpu_torch.protocol.encode import encode_tones
    from ft8_demodulator_tpu_torch.protocol.message import pack_message

    lines, edges, host_out = [], 0, {}
    with tempfile.TemporaryDirectory() as tmp:
        wav = {k: os.path.join(tmp, f"tx_{k}.wav") for k in ("card", "cpu")}
        tx = ["--tx", CLI_TX, "--tx-snr", CLI_TX_SNR, "--tx-seed",
              CLI_TX_SEED]
        out_card, s_card = _cli_run(tx + [wav["card"]], cpu=False)
        out_cpu, s_cpu = _cli_run(tx + [wav["cpu"]], cpu=True)
        if out_card.replace(wav["card"], "W") != \
                out_cpu.replace(wav["cpu"], "W"):
            raise RuntimeError(f"cli --tx: card {out_card!r}, CPU "
                               f"{out_cpu!r}")
        a, fa = read_wave_file(wav["card"])
        b, fb = read_wave_file(wav["cpu"])
        tx_err = float(np.abs(a - b).max())
        if fa != fb or a.shape != b.shape or tx_err > 1e-3:
            raise RuntimeError(f"cli --tx: the card's WAV {tx_err} off the "
                               "CPU's")
        lines.append(f"--tx {s_card:.1f} s (CPU {s_cpu:.1f} s, WAVs "
                     f"{tx_err:.1e} apart)")

        # a 4-cycle beacon at 12 kHz for --stack
        fs = 12000.0
        n = int(SLOT_S * fs)
        w = _baseband_complex(encode_tones(torch.as_tensor(pack_message(
            DEMO_MESSAGE))), int(C.SYMBOL_PERIOD_S * fs), fs,
            CLI_BEACON_F0).real.numpy()
        cyc = np.random.default_rng(17).standard_normal((4, n))
        cyc[:, 6000: 6000 + len(w)] += _amplitude(CLI_BEACON_SNR_DB, fs) * w
        flat = cyc.reshape(-1)
        beacon = os.path.join(tmp, "beacon.wav")
        write_wave_file(beacon, flat / np.abs(flat).max() * 0.8, fs)

        for name, args in (("default", [wav["card"]]),
                           ("--deep", [wav["card"], "--deep"]),
                           ("--stream", [wav["card"], "--stream"]),
                           ("--format json", [wav["card"], "--format",
                                              "json"]),
                           ("--stack 4 --osd", [beacon, "--stack", "4",
                                                "--osd"])):
            out_card, s_card = _cli_run(args, cpu=False)
            out_cpu, s_cpu = _cli_run(args, cpu=True)
            host_out[name] = out_cpu
            edges += _cli_same(name, out_card, out_cpu)
            want = DEMO_MESSAGE if name.startswith("--stack") else CLI_TX
            if name == "--format json":
                rows = [json.loads(ln) for ln in out_card.splitlines()]
                found = [r["message"] for r in rows]
            else:
                found = [ln[len("Message: "):] for ln in
                         out_card.splitlines() if ln.startswith("Message: ")]
            if want not in found:
                raise RuntimeError(f"cli {name}: {want!r} not decoded: "
                                   f"{found}")
            lines.append(f"{name} {s_card:.1f} s (CPU {s_cpu:.1f} s, "
                         f"{len(found)} rows)")

        # the CLI's --deep in this process: the kernels it launches
        torch.cuda.synchronize()
        _reset_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main([wav["card"], "--deep"])
        torch.cuda.synchronize()
        k4 = _counter("k4.launches")
        k6 = _counter("k6.launches")
        k7 = _counter("k7.launches")
        k9 = _counter("k9.launches")
        _cli_same("--deep in process", buf.getvalue(), host_out["--deep"])
    if rc != 0 or k6 < 1 or k4 < 1 or k7 < 1 or k9 != k6:
        raise RuntimeError(f"cli --deep in process: exit {rc}, sync kernel "
                           f"{k6}, OSD kernel {k4}, BP + CRC kernel {k7}, "
                           f"top-K kernel {k9} launches")
    _phase(17, f"[{smi}] python -m ft8_demodulator_tpu_torch.cli, stdout on "
               "the card == stdout with FT8_PLATFORM=cpu (score / SNR one "
               f"last digit apart: {edges} lines); wall time per process "
               "(start, import, kernel load and decode): " + "; ".join(lines)
               + f"; --deep in this process: sync kernel launches {k6}, "
               f"top-K kernel launches {k9}, OSD "
               f"kernel launches {k4}, BP + CRC kernel launches {k7}")
    return k4, k6


# parallel/ (phase 18): torch.distributed ranks.  The machine has one card,
# and NCCL takes one rank a card: NCCL runs at world size 1, and four gloo
# ranks share cuda:0 (their collectives cross the host).  Four ranks on one
# card measure the collectives' overhead and correctness, not scaling.
PAR_FS = 12000.0
PAR_SECONDS = 60
PAR_SEED = 18
PAR_SNR_DB = -6.0
# (channel, message, start s, f0 Hz): the last one straddles the 30-s edge
# of the two stream blocks
PAR_EVENTS = ((0, "CQ K1ABC FN42", 2.0, 1500.0),
              (1, "CQ W9XYZ EN37", 46.0, 2600.0),
              (1, "CQ DL1ABC JO62", 24.0, 800.0))
PAR_RANKS = 4
PAR_PP_SLOTS = 4
PAR_TIMEOUT_S = 300.0
# the launches each rank counts: the frequency-major sync kernel (K6), the
# OSD kernel (K4), BP + CRC (K7), the LLR kernel (K8) and the top-K kernel
# (K9), as the profiler names them
LAUNCH_NAMES = "sync_kernel<false,...> / osd_decode_kernel / " \
    "ldpc_bp_kernel / llr_kernel / topk_select_kernel"
# the regimes on PAR_RANKS ranks: (name, what the parent checks)
PAR_REGIMES = ("DP x SP 2x2", "TP 4 osr 2x2", "TP 4 osr 4x4 OSD MF",
               "PP 2 stages OSD", "composed 1x2x2")


def _parallel_capture():
    """(2, 60 s) float32 numpy at 12 kHz from default_rng(PAR_SEED) with
    PAR_EVENTS at PAR_SNR_DB, and {payload: (channel, text, t, f0)}."""
    from ft8_demodulator_tpu_torch.ops.gfsk import _baseband_complex
    from ft8_demodulator_tpu_torch.protocol import constants as C
    from ft8_demodulator_tpu_torch.protocol.encode import encode_tones
    from ft8_demodulator_tpu_torch.protocol.message import pack_message

    fs = PAR_FS
    n = int(PAR_SECONDS * fs)
    sps = int(C.SYMBOL_PERIOD_S * fs)
    audio = np.random.default_rng(PAR_SEED).standard_normal((2, n))
    planted = {}
    for ch, text, t, f0 in PAR_EVENTS:
        payload = pack_message(text)
        w = _baseband_complex(encode_tones(torch.as_tensor(payload)), sps,
                              fs, f0).real.numpy()
        i = int(round(t * fs))
        audio[ch, i: i + len(w)] += _amplitude(PAR_SNR_DB, fs) * w
        planted[bytes(payload)] = (ch, text, t, f0)
    return audio.astype(np.float32), planted


def _host_result(result):
    """Rows (or None) as they are; a SlotDecodeResult's tensors as numpy
    (what a rank sends back)."""
    if result is None or isinstance(result, list):
        return result
    return type(result)(*(f.cpu().numpy() for f in result))


def _rows_text(result) -> str:
    return str(len(result) if isinstance(result, list)
               else int(result.success.sum()))


def _ms_text(ms) -> str:
    """A rank's ms; "not measured" for CPU ranks (a rehearsal on the CPU
    maps the card's ranks to CPU ones)."""
    return "not measured" if ms is None else f"{ms:.1f} ms"


def _rank_ms(call, device) -> float | None:
    """Host ms of one call on the card, every rank starting together and
    ending at a synchronize (None on CPU ranks: no device time)."""
    import torch.distributed as dist

    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    if dist.get_world_size() > 1:
        dist.barrier()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _counted(calls: dict, device) -> dict:
    """Each call once with the K6 / K4 / K7 / K8 / K9 counts from 0 (the
    phase's main path), then once more timed on the card: name -> (result,
    (K6, K4, K7, K8, K9) launches of this rank, ms)."""

    out = {}
    for name, call in calls.items():
        _reset_counts()
        result = call()
        if device.type == "cuda":
            torch.cuda.synchronize()
        launches = tuple(_counter(f"{k}.launches")
                         for k in ("k6", "k4", "k7", "k8", "k9"))
        out[name] = (_host_result(result), launches, _rank_ms(call, device))
    return out


def _nccl_rank(device, audio, slot) -> dict:
    """Phase 18 (a), on one rank: decode_stream on phase 16's stream
    (STANDARD and use_osd + mf_first) and decode_slot_tp on one slot over
    a one-rank freq mesh."""
    from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu_torch.parallel import (decode_slot_tp,
                                                    decode_stream,
                                                    make_freq_mesh)

    p = waterfall_params(STREAM_FS, 2, 2)
    freq = make_freq_mesh(1, device=device)
    return _counted({
        "stream STANDARD": lambda: decode_stream(audio, STREAM_FS,
                                                 device=device),
        "stream OSD mf_first": lambda: decode_stream(
            audio, STREAM_FS, use_osd=True, mf_first=True, device=device),
        "TP 1": lambda: decode_slot_tp(slot, p, p.num_frames(len(slot)),
                                       freq, device=device),
    }, device)


def _regime_rank(device, capture, slot, waves) -> dict:
    """Phase 18 (b), on each of PAR_RANKS ranks: the four regimes at the
    production geometry."""
    from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu_torch.parallel import (
        decode_slot_tp, decode_slots_pipelined, decode_stream,
        decode_stream_composed, make_composed_mesh, make_freq_mesh,
        make_mesh, make_stage_mesh)

    fs = PAR_FS
    p2, p4 = waterfall_params(fs, 2, 2), waterfall_params(fs, 4, 4)
    nf2, nf4 = p2.num_frames(len(slot)), p4.num_frames(len(slot))
    mesh = make_mesh(stream=2, channel=2, device=device)
    freq = make_freq_mesh(PAR_RANKS, device=device)
    stages = make_stage_mesh(2, device=device)
    composed = make_composed_mesh(1, 2, 2, device=device)
    calls = dict(zip(PAR_REGIMES, (
        lambda: decode_stream(capture, fs, mesh=mesh, device=device),
        lambda: decode_slot_tp(slot, p2, nf2, freq, device=device),
        lambda: decode_slot_tp(slot, p4, nf4, freq, max_candidates=40,
                               min_score=1.0, use_osd=True, use_mf=True,
                               device=device),
        lambda: decode_slots_pipelined(waves, p2, nf2, stages, use_osd=True,
                                       device=device),
        lambda: decode_stream_composed(capture, fs, composed,
                                       device=device))))
    return _counted(calls, device)


def _same_result(name: str, got, want) -> None:
    """Rows: payload, time and frequency equal, score within
    API_SCORE_ATOL; a SlotDecodeResult: every field equal but the score,
    within API_SCORE_ATOL on the valid candidates."""
    if isinstance(got, list):
        key = lambda rows: [(r.message.payload, r.time_sec, r.freq_hz)
                            for r in rows]
        ok = key(got) == key(want) and all(
            abs(a.score - b.score) <= API_SCORE_ATOL
            for a, b in zip(got, want))
    else:
        valid = want.candidate_valid
        ok = all(np.array_equal(a, b) for f, a, b in
                 zip(got._fields, got, want) if f != "score") and bool(
            (np.abs(got.score[valid] - want.score[valid])
             <= API_SCORE_ATOL).all())
    if not ok:
        raise RuntimeError(f"{name}: {got} != {want}")


def _planted_once(name: str, rows, planted: dict) -> None:
    """Each planted payload reported once near its time and frequency, and
    nothing else."""
    for payload, (*_, text, t, f0) in planted.items():
        hit = [r for r in rows if r.message.payload == payload]
        if len(hit) != 1 or abs(hit[0].time_sec - t) > STREAM_TIME_ATOL \
                or abs(hit[0].freq_hz - f0) > STREAM_FREQ_ATOL:
            raise RuntimeError(f"{name}: {text!r} at {t} s {f0} Hz reported "
                               f"{len(hit)} times: {_demo_rows_text(hit)}")
    extra = {r.message.payload for r in rows} - set(planted)
    if extra:
        raise RuntimeError(f"{name}: unplanted rows {extra}")


def _parallel_phase(dev, smi: str) -> tuple[int, int]:
    """Phase 18: parallel/ on ranks of torch.distributed.  Returns the OSD
    and the frequency-major sync kernels' launches of the card's ranks."""
    from ft8_demodulator_tpu_torch.demod.decode import decode_waterfall
    from ft8_demodulator_tpu_torch.demod.types import SlotDecodeResult
    from ft8_demodulator_tpu_torch.ops.sync import search_grid
    from ft8_demodulator_tpu_torch.ops.waterfall import (waterfall_params,
                                                         waterfall_real)
    from ft8_demodulator_tpu_torch.parallel import (decode_slot_tp,
                                                    decode_stream)
    from ft8_demodulator_tpu_torch.parallel.dryrun import dryrun_multichip
    from ft8_demodulator_tpu_torch.parallel.launch import run_ranks

    k4_total = k6_total = 0
    t0 = time.perf_counter()

    # (a) NCCL at world size 1
    audio, planted = _stream_audio()
    slot = _crowded_capture()[0]
    args = (audio, slot)
    card = run_ranks(_nccl_rank, 1, "nccl", dev, args, PAR_TIMEOUT_S)[0]
    host = run_ranks(_nccl_rank, 1, "gloo", "cpu", args, PAR_TIMEOUT_S)[0]
    texts = []
    for name, (result, (k6, k4, k7, k8, k9), ms) in card.items():
        _same_result(f"NCCL {name}", result, host[name][0])
        if name.startswith("stream"):
            _planted_once(f"NCCL {name}", result, planted)
        if k6 < 1 or (k4 > 0) != ("OSD" in name) or k7 < 1 \
                or k8 != _k8_want(k6, "mf_first" in name) or k9 != k6:
            raise RuntimeError(f"NCCL {name}: K6 {k6}, K4 {k4}, K7 {k7}, "
                               f"K8 {k8}, K9 {k9} launches")
        k6_total += k6
        k4_total += k4
        texts.append(f"{name} {_rows_text(result)} rows == CPU, "
                     f"{LAUNCH_NAMES} {k6}/{k4}/{k7}/{k8}/{k9}, "
                     f"{_ms_text(ms)}")
    _phase(18, f"[{smi}] NCCL world size 1 (run_ranks, one rank on "
               f"{dev}): phase 16's {STREAM_SECONDS}-s {STREAM_FS / 1000:g} "
               "kHz stream, each planted signal once; " + "; ".join(texts)
               + " (host ms of a warm call to a synchronize)")

    # (b) PAR_RANKS gloo ranks sharing the card
    dry = dryrun_multichip(PAR_RANKS, "gloo", dev)
    for r in dry:
        k6_total += r["launches"]["K6"]
        k4_total += r["launches"]["K4"]
    capture, par_planted = _parallel_capture()
    waves = _synth_slots("cpu", PAR_FS, PAR_PP_SLOTS, seed=PAR_SEED)[0] \
        .numpy()
    args = (capture, slot, waves)
    card = run_ranks(_regime_rank, PAR_RANKS, "gloo", dev, args,
                     PAR_TIMEOUT_S)
    host = run_ranks(_regime_rank, PAR_RANKS, "gloo", "cpu", args,
                     PAR_TIMEOUT_S)
    # the port's one-rank path, on the card in this process
    p2, p4 = waterfall_params(PAR_FS, 2, 2), waterfall_params(PAR_FS, 4, 4)
    nf2, nf4 = p2.num_frames(len(slot)), p4.num_frames(len(slot))
    one_stream = decode_stream(capture, PAR_FS, device=dev)
    g = search_grid(p2.num_freq_bins, nf2, p2.time_osr, p2.freq_osr)
    per_slot = [decode_waterfall(waterfall_real(
        torch.as_tensor(w, device=dev), p2, nf2), g, 20, 10.0, use_osd=True)
        for w in waves]
    single = dict(zip(PAR_REGIMES, (
        one_stream,
        _host_result(decode_slot_tp(slot, p2, nf2, None, device=dev)),
        _host_result(decode_slot_tp(slot, p4, nf4, None, max_candidates=40,
                                    min_score=1.0, use_osd=True, use_mf=True,
                                    device=dev)),
        _host_result(SlotDecodeResult(*(torch.stack(f)
                                        for f in zip(*per_slot)))),
        one_stream)))
    _planted_once("one-rank stream", one_stream, par_planted)
    texts = []
    for name in PAR_REGIMES:
        ranks_in = [r for r in range(PAR_RANKS)
                    if card[r][name][0] is not None]
        for r in ranks_in:
            _same_result(f"{name} rank {r} card vs CPU", card[r][name][0],
                         host[r][name][0])
            _same_result(f"{name} rank {r} vs one rank", card[r][name][0],
                         single[name])
        launches = [card[r][name][1] for r in ranks_in]
        fronts = launches[:1] if name.startswith("PP") else launches
        backs = launches[1:] if name.startswith("PP") else launches
        # each rank's sync launches are each followed by one LLR launch
        # and one top-K launch
        if any(k6 < 1 for k6, *_ in fronts) \
                or any(k7 < 1 for _, _, k7, *_ in backs) or (
                "OSD" in name and any(k4 < 1 for _, k4, *_ in backs)) \
                or any(k8 != _k8_want(k6, False) or k9 != k6
                       for k6, _, _, k8, k9 in launches):
            raise RuntimeError(f"{name}: K6/K4/K7/K8/K9 launches per rank "
                               f"{launches}")
        k6_total += sum(k6 for k6, *_ in launches)
        k4_total += sum(k4 for _, k4, *_ in launches)
        ms = [card[r][name][2] for r in range(PAR_RANKS)]
        texts.append(f"{name}: {_rows_text(card[ranks_in[0]][name][0])} "
                     f"rows on ranks {ranks_in} == CPU == one rank, "
                     f"{LAUNCH_NAMES} per rank {launches}, "
                     f"{_ms_text(None if None in ms else max(ms))}")
    _planted_once("DP x SP", card[0]["DP x SP 2x2"][0], par_planted)
    _planted_once("composed", card[0]["composed 1x2x2"][0], par_planted)
    _phase(18, f"[{smi}] {PAR_RANKS} gloo ranks on {dev} (collectives' "
               "overhead and correctness, not scaling): dryrun_multichip "
               f"launches per rank {[r['launches'] for r in dry]}; "
               f"{PAR_SECONDS}-s 2-channel capture, {len(PAR_EVENTS)} "
               f"signals at {PAR_SNR_DB:g} dB, each once; "
               + "; ".join(texts) + " (host ms of a warm call to a "
               "synchronize, the slowest rank); phase "
               f"{time.perf_counter() - t0:.1f} s")
    return k4_total, k6_total


# the soak on the card (phase 19): the draws of benchmarks/soak.py
# (tests/_torch_soak_cases.py: the port's TX on the CPU and numpy noise),
# decoded on the card and on the CPU
SOAK_HALVES = ((-10.0, 1), (-19.0, 2))   # (SNR dB, seed) of each half
SOAK_TRIALS = 32                          # a half
SOAK_SLOT_SEED = 19
SOAK_SLOT_DRAWS = 12
SOAK_SLOT_BATCH = 4
# three signals a slot at -16 dB and one at -8 (over the noise in fs/2)
SOAK_SLOT_SNR_DB = (-16.0, -16.0, -16.0, -8.0)
SOAK_OSR = (2, 3, 4)
SOAK_RUNS = {
    "STANDARD": dict(max_candidates=MAX_CANDIDATES, min_score=MIN_SCORE),
    "DEEP": dict(max_candidates=DEEP_CANDIDATES, min_score=DEEP_MIN_SCORE,
                 use_osd=True, mf_first=True)}
GENERIC_K6 = "<false, 0, 0>"


def _tests_module(name: str):
    """A helper module of tests/ that imports no JAX
    (_torch_soak_cases, _torch_k8_model)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def _k6_instance(tau: int, phi: int) -> str:
    """The frequency-major sync kernel's template instance at osr tau x
    phi (csrc/sync_stencil.cu launch_osr)."""
    if (tau, phi) in ((2, 2), (4, 4)):
        return f"<false, {tau}, {phi}>"
    return GENERIC_K6


def _soak_api(dev, soak) -> tuple[int, dict, str]:
    """Phase 19 (a): decode_ft8_message on every soak trial, card vs CPU.
    Returns (OSD kernel launches, frequency-major sync kernel launches by
    (tau, phi), a report)."""
    from collections import Counter

    from ft8_demodulator_tpu_torch.demod.decode import decode_ft8_message

    k6 = Counter()
    k4_total = k7_total = rows = 0
    decoded = {}
    for snr, seed in SOAK_HALVES:
        trials = soak.soak_trials(seed, SOAK_TRIALS, snr)
        for t in trials:
            name = f"soak trial {json.dumps(t.repro)}"
            _reset_counts()
            card = decode_ft8_message(t.audio, t.fs, device=dev,
                                      **t.decode_kwargs)
            torch.cuda.synchronize()
            launches = tuple(_counter(f"{k}.launches")
                             for k in ("k6", "k4", "k7", "k8", "k9"))
            host = decode_ft8_message(t.audio, t.fs, device="cpu",
                                      **t.decode_kwargs)
            _check_api_rows(name, card, host)
            if launches[0] < 1 or (launches[1] > 0 and not t.use_osd) \
                    or launches[2] < 1 or launches[3] != _k8_want(
                        launches[0], t.decode_kwargs.get("mf_first", False)) \
                    or launches[4] != launches[0]:
                raise RuntimeError(f"{name}: K6 / K4 / K7 / K8 / K9 launches "
                                   f"{launches}")
            if snr == SOAK_HALVES[0][0]:
                why = soak.planted_fault(t, card)
                if why is not None:
                    raise RuntimeError(f"{name}: {why}")
            k6[(t.osr, t.osr)] += launches[0]
            k4_total += launches[1]
            k7_total += launches[2]
            rows += len(card)
            decoded[snr] = decoded.get(snr, 0) + any(
                r.message.payload == t.payload for r in card)
    by_instance = Counter()
    for (tau, phi), n in k6.items():
        by_instance[_k6_instance(tau, phi)] += n
    if by_instance[GENERIC_K6] < 1:
        raise RuntimeError(f"the generic sync instance {GENERIC_K6} never "
                           f"launched: {dict(by_instance)}")
    text = (f"{len(SOAK_HALVES) * SOAK_TRIALS} decode_ft8_message trials "
            "(mf_first, min_score 1, osr = the trial's, OSD every other), "
            f"{rows} rows, card rows == CPU rows in every trial; planted "
            "payload decoded on the card: " + ", ".join(
                f"{decoded[snr]}/{SOAK_TRIALS} at {snr:g} dB (seed {seed})"
                for snr, seed in SOAK_HALVES)
            + f", every {SOAK_HALVES[0][0]:g}-dB trial within soak.py's "
            "time / frequency / SNR tolerances; sync_kernel launches by "
            "(tau, phi) " + ", ".join(f"{k[0]}x{k[1]} {n}"
                                      for k, n in sorted(k6.items()))
            + ", by instance " + ", ".join(
                f"{k} {n}" for k, n in sorted(by_instance.items()))
            + f"; osd_decode_kernel launches {k4_total}, ldpc_bp_kernel "
            f"launches {k7_total}")
    return k4_total, k6, text


def _soak_slots(dev, soak) -> tuple[int, int, list[str]]:
    """Phase 19 (b): decode_slots at drawn geometries, the card's kernels
    against their plain versions at each and the card's decode sets
    against the CPU's.  Returns (OSD kernel launches, frequency-major sync
    kernel launches, a report a draw)."""
    from ft8_demodulator_tpu_torch.demod.decode import decode_slots
    from ft8_demodulator_tpu_torch.ops import sync as so
    from ft8_demodulator_tpu_torch.ops import sync_cuda as sc
    from ft8_demodulator_tpu_torch.ops import waterfall_cuda as wc
    from ft8_demodulator_tpu_torch.ops.waterfall import (_pick_backend,
                                                         waterfall_params,
                                                         waterfall_real)

    k1, k3 = wc.block_waterfall_tf_fused_batch, \
        wc.block_waterfall_mf_tf_fused_batch
    rng = np.random.default_rng(SOAK_SLOT_SEED)
    k4_total = k6_total = 0
    texts = []
    for i in range(SOAK_SLOT_DRAWS):
        fs = float(rng.choice(soak.RATES))
        tau, phi = (int(v) for v in rng.choice(SOAK_OSR, 2))
        slot_s = float(rng.choice(soak.SLOT_SECONDS))
        run = "DEEP" if rng.integers(2) else "STANDARD"
        seed = int(rng.integers(2 ** 31))
        repro = {"draw": i, "seed": seed, "fs": fs, "time_osr": tau,
                 "freq_osr": phi, "slot_s": slot_s, "run": run}
        name = f"soak slots {json.dumps(repro)}"
        waves, planted = soak.slot_batch(seed, fs, slot_s, SOAK_SLOT_BATCH,
                                         SOAK_SLOT_SNR_DB)
        p = waterfall_params(fs, phi, tau)
        nf = p.num_frames(waves.shape[1])
        kw = SOAK_RUNS[run]
        w = torch.as_tensor(waves, device=dev)
        block = _pick_backend(p, None) == "block"
        _reset_counts()
        out = []
        osd_calls = _capture_osd_inputs(lambda: out.append(decode_slots(
            w, p, nf, chunk=SOAK_SLOT_BATCH, **kw)))
        torch.cuda.synchronize()
        launches = {k: _counter(f"{k.lower()}.launches")
                    for k in ("K1", "K3", "K5", "K6", "K8", "K9", "K4",
                              "K7")}
        front = ("K3" if run == "DEEP" else "K1", "K5") if block else ("K6",)
        want = {k: (SOAK_SLOT_BATCH if k == "K6" else 1) for k in front}
        want["K4"] = len(osd_calls)
        # BP + CRC: one group of the batch; off the block route one a slot
        want["K7"] = 1 if block else SOAK_SLOT_BATCH
        # LLRs: one the chunk; off the block route one a slot on the Hann
        # route, none on the matched-filter one
        want["K8"] = 1 if block else _k8_want(SOAK_SLOT_BATCH,
                                              kw.get("mf_first", False))
        # top-K: one the chunk; off the block route one a slot
        want["K9"] = 1 if block else SOAK_SLOT_BATCH
        if {k: n for k, n in launches.items() if n} != \
                {k: n for k, n in want.items() if n} \
                or (run == "DEEP") != bool(osd_calls):
            raise RuntimeError(f"{name}: launches {launches}, want {want} "
                               f"({len(osd_calls)} OSD calls)")
        k4_total += launches["K4"]
        k6_total += launches["K6"]
        card_sets = _decode_sets(out[0], SOAK_SLOT_BATCH)
        host_sets = _decode_sets(decode_slots(
            torch.as_tensor(waves), p, nf, chunk=SOAK_SLOT_BATCH, **kw),
            SOAK_SLOT_BATCH)
        if card_sets != host_sets:
            raise RuntimeError(f"{name}: card decodes {card_sets}, CPU "
                               f"decodes {host_sets}")
        checks = []
        g = so.search_grid(p.num_freq_bins, nf, tau, phi)
        if block:
            if run == "DEEP":
                db, box = k3(w, p, nf)
                torch.cuda.synchronize()
                want_db, want_box = \
                    wc.block_waterfall_mf_tf_fused_batch_plain(w, p, nf)
                box_err = _check_box(name, box, want_box)
            else:
                db = k1(w, p, nf)
                torch.cuda.synchronize()
                want_db = wc.block_waterfall_tf_fused_batch_plain(w, p, nf)
            checks.append(f"{front[0]} " + _check_db(
                "dB", db, want_db, _exact_db(w, p, nf)))
            if run == "DEEP":
                checks.append(f"boxcar {box_err:.3e}")
            _check_sync(f"{name} K5", sc.sync_scores_tf_kernel(db, g),
                        so.sync_scores_tf(db, g))
            checks.append("K5 == plain")
        else:
            for b in range(SOAK_SLOT_BATCH):
                mag = waterfall_real(w[b], p, nf)
                _check_sync(f"{name} K6 slot {b}", sc.sync_scores_kernel(
                    mag, g), so.sync_scores(mag, g))
            checks.append(f"non-block geometry: K6 == plain on "
                          f"{SOAK_SLOT_BATCH} slots")
        for j, (llr, need) in enumerate(osd_calls):
            checks.append(f"K4 == the CPU route on OSD call {j}: "
                          + _check_osd_decode(llr, need,
                                              f"{name} OSD call {j}")[0])
        found = sum(len(set(pl) & {d[0] for d in card_sets[b]})
                    for b, pl in enumerate(planted))
        texts.append(f"{fs / 1000:g} kHz {tau}x{phi} {slot_s:g} s {run}: "
                     f"{sum(map(len, card_sets))} decodes == CPU ({found}/"
                     f"{SOAK_SLOT_BATCH * len(SOAK_SLOT_SNR_DB)} planted), "
                     f"launches {launches}; " + ", ".join(checks))
    return k4_total, k6_total, texts


def _soak_phase(dev, smi: str) -> tuple[int, int]:
    """Phase 19: the reference soak's random coverage on the card.
    Returns the OSD and the frequency-major sync kernels' launches."""
    soak = _tests_module("_torch_soak_cases")
    t0 = time.perf_counter()
    k4_api, k6_api, text = _soak_api(dev, soak)
    _phase(19, text)
    k4_slots, k6_slots, texts = _soak_slots(dev, soak)
    _phase(19, f"decode_slots batch {SOAK_SLOT_BATCH} at "
               f"{SOAK_SLOT_DRAWS} drawn geometries (seed {SOAK_SLOT_SEED}; "
               f"signals at {SOAK_SLOT_SNR_DB} dB): " + "; ".join(texts)
               + f" (dB bounds {ATOL_DB} / {NULL_ATOL_DB}, boxcar {BOX_RTOL},"
               " K4 / K5 / K6 bit for bit)")
    _phase(19, f"[{smi}] phase {time.perf_counter() - t0:.1f} s")
    return k4_api + k4_slots, sum(k6_api.values()) + k6_slots


BP_SOURCE = "ft8_demodulator_tpu_torch/csrc/ldpc_bp.cu"
BP_NO_TPU_KERNEL = ("no TPU kernel: the JAX package runs BP as one jitted "
                    "lax.while_loop (ft8_demodulator_tpu/ops/"
                    "ldpc_decode.py:187)")


def _bp_inputs(dev, waves) -> dict:
    """The LLRs BP + CRC is handed on the main paths: phase 4's first BP
    group (decode_slots STANDARD, 5,120 rows) and phase 12's crowded
    capture (decode_ft8_message's defaults, 20 rows)."""
    from ft8_demodulator_tpu_torch.demod import decode as dec
    from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

    seen, entry = [], dec.bp_crc_batch

    def keep(llrs, *args):
        seen.append(llrs)
        return entry(llrs, *args)

    p = waterfall_params(FS, 2, 2)
    dec.bp_crc_batch = keep
    try:
        dec.decode_slots(waves, p, p.num_frames(waves.shape[1]), chunk=CHUNK,
                         bp_chunk=BP_CHUNK, max_candidates=MAX_CANDIDATES,
                         min_score=MIN_SCORE, max_iterations=BP_ITERATIONS)
        batch = seen[0]
        dec.decode_ft8_message(_crowded_capture()[0], FS, device=dev)
        station = seen[-1]
    finally:
        dec.bp_crc_batch = entry
    out = {"5,120 rows": batch, "20 rows": station}
    for label, llrs in out.items():
        want = int(label.split()[0].replace(",", ""))
        if tuple(llrs.shape) != (want, 174):
            raise RuntimeError(f"BP input {label}: {tuple(llrs.shape)}")
    return out


def _bp_phase(dev, smi: str, waves, log: str, launches: int) -> dict:
    """Phase 20: K7 against the plain loop and its bound.  Returns its JSON
    record, with ``launches`` (phase 4's, on the main path)."""
    from ft8_demodulator_tpu_torch.ops import ldpc_cuda as lc
    from ft8_demodulator_tpu_torch.ops import ldpc_decode as bp

    tables = bp.bp_tables(dev)
    texts, times = [], {}
    for label, llrs in _bp_inputs(dev, waves).items():
        flat = llrs.reshape(-1, 174).contiguous()
        got = bp.bp_crc_batch(flat, BP_ITERATIONS)
        want = bp.bp_crc_batch_plain(flat, BP_ITERATIONS)
        torch.cuda.synchronize()
        bad = [f for f, a, b in zip(want._fields, got, want)
               if not torch.equal(a, b)]
        if bad:
            raise RuntimeError(f"K7 vs plain on {label}: {bad} differ")
        kernel_ms, plain_ms, plain_ev, _ = _kernel_vs_plain_ms(
            lambda: lc.bp_crc_kernel(flat, BP_ITERATIONS, tables.k7_table),
            lambda: bp.bp_crc_batch_plain(flat, BP_ITERATIONS),
            "ldpc_bp_kernel", reps=20, plain_reps=3)
        bound_ms = lc.bp_bound(got.iterations) * 1e3
        it = got.iterations.float()
        times[label] = (kernel_ms, plain_ms, bound_ms)
        texts.append(f"{label}: K7 == plain bit for bit, iterations mean "
                     f"{float(it.mean()):.2f} max {int(it.max())}, "
                     f"{int((got.crc_calc == got.crc_extracted).sum())} "
                     f"CRC passes; K7 {kernel_ms:.4f} ms (bound "
                     f"{bound_ms:.6f} ms by operations, "
                     f"{100 * bound_ms / kernel_ms:.1f} %), plain "
                     f"{plain_ms:.4f} ms ({plain_ev} device events per "
                     "call)")
    report, keep = [], False
    for line in _ptxas_report(log):
        if line.endswith(":"):
            keep = line.startswith("ldpc_bp_kernel")
        if keep:
            report.append(line)
    _phase(20, f"[{smi}] BP + CRC (K7) vs the plain loop, device time over "
               "20 warm launches (plain: 3 calls), min of 2 counted "
               "windows: " + "; ".join(texts) + "; ptxas: "
               + " | ".join(report))
    ms, plain_ms, bound_ms = times["5,120 rows"]
    return {"name": "ldpc_bp", "route": "cuda", "source": BP_SOURCE,
            "replaces": None, "launches": launches, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations", "library_ms": None,
            "library_note": BP_NO_TPU_KERNEL}


LLR_SOURCE = "ft8_demodulator_tpu_torch/csrc/llr_gather.cu"
# K8's scale against PyTorch's (normalize_llrs): its sums run in another
# order
LLR_SCALE_ULPS = 4
LLR_NO_TPU_KERNEL = ("no TPU kernel: the JAX package reads the LLR cells "
                     "through one-hot matmuls that XLA fuses "
                     "(ft8_demodulator_tpu/ops/llr.py)")


def _llr_inputs(dev, waves) -> dict:
    """The LLR layer's inputs on the batch paths: the first chunk of phase
    4's STANDARD decode (16 slots' time-major dB grids, K 20) and of phase
    9's DEEP one (8 slots' boxcar grids, K 40), with their top-K
    candidates: (grid, abs_time, abs_freq, search grid, boxcar route,
    Gray map) by label."""
    from ft8_demodulator_tpu_torch.demod import decode as dec
    from ft8_demodulator_tpu_torch.ops import waterfall_cuda as wc
    from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params
    from ft8_demodulator_tpu_torch.protocol.tables import device_table

    out = {}
    for label, osr, chunk, k, min_score, matched in (
            (f"STANDARD {CHUNK}xK{MAX_CANDIDATES}", (2, 2), CHUNK,
             MAX_CANDIDATES, MIN_SCORE, False),
            (f"DEEP {DEEP_CHUNK}xK{DEEP_CANDIDATES}", DEEP_OSR, DEEP_CHUNK,
             DEEP_CANDIDATES, DEEP_MIN_SCORE, True)):
        p = waterfall_params(FS, *osr)
        nf = p.num_frames(waves.shape[1])
        decoder = dec.slot_decoder(p, nf, dev)
        w = waves[:chunk].contiguous()
        if matched:
            mags, grid = wc.block_waterfall_mf_tf_fused_batch(
                w, p, nf, decoder.waterfall_consts())
        else:
            grid = mags = wc.block_waterfall_tf_fused_batch(
                w, p, nf, decoder.waterfall_consts())
        at, af, _, _ = dec._candidates(mags, decoder.g, k, min_score)
        out[label] = (grid, at, af, decoder.g, matched,
                      device_table("GRAY_MAP", dev))
    return out


def _llr_phase(dev, smi: str, waves, log: str, launches: int) -> dict:
    """Phase 21: K8 against the plain route and its bound, and no K8 in a
    beacon cycle.  Returns its JSON record (launches: phase 4's)."""
    from ft8_demodulator_tpu_torch.demod import BeaconSession
    from ft8_demodulator_tpu_torch.ops import llr as ll
    from ft8_demodulator_tpu_torch.ops import llr_cuda as lk

    k8 = _tests_module("_torch_k8_model")
    texts, times, errs = [], {}, {}
    for label, (grid, at, af, g, matched, gray) in _llr_inputs(
            dev, waves).items():
        args = (grid, at, af, g.time_osr, g.freq_osr, g.num_blocks, matched,
                gray)
        if matched:
            def plain_raw():
                return ll._grid_llrs_plain(grid, at, af, g.time_osr,
                                           g.freq_osr)
        else:
            def plain_raw():
                return ll._hann_llrs_plain(grid, at, af, g.time_osr,
                                           g.freq_osr, g.num_blocks)
        llrs = lk.llr_kernel(*args)
        want = plain_raw()
        torch.cuda.synchronize()
        # the model's scale from the plain LLRs before scaling: K8's rows
        # are their product bit for bit (the gather and the scale at once)
        scale = torch.as_tensor(k8.scales(want.cpu().numpy().reshape(
            -1, 174)), device=dev).reshape(want.shape[:-1])
        product = want * scale[..., None]
        if not torch.equal(llrs, product):
            raise RuntimeError(f"K8 vs plain on {label}: "
                               f"{int((llrs != product).sum())} LLRs differ "
                               "from the plain ones before scaling times "
                               "the model's scale")
        ulps = int(k8.ulps(scale.cpu().numpy(),
                           ll._llr_scale(want).cpu().numpy()).max())
        if ulps > LLR_SCALE_ULPS:
            raise RuntimeError(f"K8 vs plain on {label}: scale {ulps} ulp "
                               f"from PyTorch's (bound {LLR_SCALE_ULPS})")
        errs[label] = float((llrs - ll.normalize_llrs(want)).abs().max())
        kernel_ms, plain_ms, plain_ev, _ = _kernel_vs_plain_ms(
            lambda: lk.llr_kernel(*args),
            lambda: ll.normalize_llrs(plain_raw()), "llr_kernel", reps=20)
        bound_ms = lk.llr_bound(at.numel()) * 1e3
        times[label] = (kernel_ms, plain_ms, bound_ms)
        texts.append(f"{label} ({at.numel()} rows): K8 == plain before "
                     f"scaling x the model's scale bit for bit, scale within "
                     f"{ulps} ulp of PyTorch's, max |K8 - normalize_llrs| "
                     f"{errs[label]:.3e}; K8 {kernel_ms:.4f} ms (bound "
                     f"{bound_ms:.6f} ms by bytes, "
                     f"{100 * bound_ms / kernel_ms:.1f} %), plain "
                     f"{plain_ms:.4f} ms ({plain_ev} device events per "
                     "call)")
    # a beacon cycle takes the block-spectra matched LLRs: no K8
    stream = _beacon_stream()[0]
    session = BeaconSession(BEACON_FS, device=dev, **BEACON_SESSION)
    _reset_counts()
    session.feed(stream[: int(BEACON_FS * SLOT_S) + 1])
    torch.cuda.synchronize()
    beacon_k7, beacon_k8 = _counter("k7.launches"), _counter("k8.launches")
    if beacon_k7 < 1 or beacon_k8 != 0:
        raise RuntimeError(f"a BeaconSession cycle launched K7 {beacon_k7} "
                           f"and K8 {beacon_k8} times (want >= 1 and 0)")
    report, keep = [], False
    for line in _ptxas_report(log):
        if line.endswith(":"):
            keep = line.startswith("llr_kernel")
        if keep:
            report.append(line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if spill and spill.group(1, 2) != ("0", "0"):
                raise RuntimeError(f"llr_kernel spills: {report}")
    _phase(21, f"[{smi}] LLRs (K8) vs the plain route, device time over 20 "
               "warm launches, min of 2 counted windows: "
               + "; ".join(texts) + f"; a BeaconSession cycle: K7 "
               f"{beacon_k7}, K8 {beacon_k8}; ptxas: " + " | ".join(report))
    ms, plain_ms, bound_ms = times[f"STANDARD {CHUNK}xK{MAX_CANDIDATES}"]
    return {"name": "llr_gather", "route": "cuda", "source": LLR_SOURCE,
            "replaces": None, "launches": launches,
            "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "library_note": LLR_NO_TPU_KERNEL}


TOPK_SOURCE = "ft8_demodulator_tpu_torch/csrc/topk_select.cu"
TOPK_NO_TPU_KERNEL = ("no TPU kernel: the JAX package selects with "
                      "lax.top_k (ft8_demodulator_tpu/ops/sync.py)")


def _topk_inputs(dev, waves) -> dict:
    """The top-K layer's inputs on the batch paths: K5's scores of the
    first chunk of phase 4's STANDARD decode (16 x 88 x 1,906, K 20,
    min_score 10) and of phase 9's DEEP one (8 x 176 x 3,812, K 40,
    min_score 1): (scores, search grid, K, min_score) by label."""
    from ft8_demodulator_tpu_torch.demod import decode as dec
    from ft8_demodulator_tpu_torch.ops import sync_cuda as sc
    from ft8_demodulator_tpu_torch.ops import waterfall_cuda as wc
    from ft8_demodulator_tpu_torch.ops.waterfall import waterfall_params

    out = {}
    for label, osr, chunk, k, min_score in (
            (f"STANDARD {CHUNK}xK{MAX_CANDIDATES}", (2, 2), CHUNK,
             MAX_CANDIDATES, MIN_SCORE),
            (f"DEEP {DEEP_CHUNK}xK{DEEP_CANDIDATES}", DEEP_OSR, DEEP_CHUNK,
             DEEP_CANDIDATES, DEEP_MIN_SCORE)):
        p = waterfall_params(FS, *osr)
        nf = p.num_frames(waves.shape[1])
        decoder = dec.slot_decoder(p, nf, dev)
        w = waves[:chunk].contiguous()
        if osr == DEEP_OSR:
            mags, _ = wc.block_waterfall_mf_tf_fused_batch(
                w, p, nf, decoder.waterfall_consts())
        else:
            mags = wc.block_waterfall_tf_fused_batch(
                w, p, nf, decoder.waterfall_consts())
        out[label] = (sc.sync_scores_tf_kernel(mags, decoder.g), decoder.g,
                      k, min_score)
    return out


def _topk_phase(dev, smi: str, waves, log: str, launches: int) -> dict:
    """Phase 22: K9 against the plain route and its bound.  Returns its
    JSON record (launches: phase 4's)."""
    from ft8_demodulator_tpu_torch.ops import sync as so
    from ft8_demodulator_tpu_torch.ops import topk_cuda as tk

    texts, times, errs = [], {}, {}
    for label, (scores, g, k, min_score) in _topk_inputs(dev,
                                                         waves).items():
        args = (scores, g.num_times, g.t_start, k, min_score)
        got = tk.topk_kernel(*args)
        want = so.find_candidates_plain(scores, g, k, min_score)
        torch.cuda.synchronize()
        for name, a, b in zip(("abs_time", "abs_freq", "score", "valid"),
                              got, want):
            if a.shape != b.shape or not torch.equal(a, b):
                raise RuntimeError(f"K9 vs plain on {label}: {name} "
                                   f"differs in {int((a != b).sum())} of "
                                   f"{b.numel()}")
        valid = want[3]
        errs[label] = float((got[2][valid] - want[2][valid]).abs().max()) \
            if bool(valid.any()) else 0.0
        kernel_ms, plain_ms, plain_ev, _ = _kernel_vs_plain_ms(
            lambda: tk.topk_kernel(*args),
            lambda: so.find_candidates_plain(scores, g, k, min_score),
            "topk_select_kernel", reps=20)
        bound_ms = tk.topk_bound(scores.shape[0], g.num_times, g.num_freqs,
                                 k) * 1e3
        times[label] = (kernel_ms, plain_ms, bound_ms)
        texts.append(f"{label} ({tuple(scores.shape)}): K9 == plain bit for "
                     f"bit (indices, scores, valid; {int(valid.sum())} valid "
                     f"of {valid.numel()}), max |score diff| "
                     f"{errs[label]:.1e}; K9 {kernel_ms:.4f} ms (bound "
                     f"{bound_ms:.6f} ms by bytes, "
                     f"{100 * bound_ms / kernel_ms:.1f} %), plain "
                     f"{plain_ms:.4f} ms ({plain_ev} device events per "
                     "call)")
    report, keep = [], False
    for line in _ptxas_report(log):
        if line.endswith(":"):
            keep = line.startswith("topk_select_kernel")
        if keep:
            report.append(line)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", line)
            if spill and spill.group(1, 2) != ("0", "0"):
                raise RuntimeError(f"topk_select_kernel spills: {report}")
    if not report:
        raise RuntimeError("no ptxas report of topk_select_kernel")
    _phase(22, f"[{smi}] candidate top-K (K9) vs the plain route, device "
               "time over 20 warm launches, min of 2 counted windows: "
               + "; ".join(texts) + "; ptxas: " + " | ".join(report))
    ms, plain_ms, bound_ms = times[f"STANDARD {CHUNK}xK{MAX_CANDIDATES}"]
    return {"name": "topk_select", "route": "cuda", "source": TOPK_SOURCE,
            "replaces": None, "launches": launches,
            "max_abs_err": max(errs.values()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "library_note": TOPK_NO_TPU_KERNEL}


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
    build_s = time.perf_counter() - t0
    sass = _sass_counts(kl.path)
    layouts = {n.split(",")[0].rstrip(">") for n in sass}
    if layouts != {f"{k}<{b}" for k in SASS_OPS for b in ("true", "false")} \
            or not all(n > 0 for c in sass.values() for n in c.values()):
        raise RuntimeError(f"the waterfall kernels' SASS lacks wgmma or TMA "
                           f"loads, or the sync kernels' cp.async or shared-"
                           f"memory loads: {sass}")
    _sync_ptxas(kl.log)
    _phase(2, f"built {kl.path.name} in {build_s:.1f} s; SASS (cuobjdump): "
              + ", ".join(f"{k} " + " ".join(f"{op} {n}"
                                             for op, n in c.items())
                          for k, c in sass.items())
              + "; ptxas: " + " | ".join(_ptxas_report(kl.log)))

    n = int(FS * SLOT_S)
    errs, texts = {}, []
    for fs, b in ((12000.0, 16), (20000.0, 4), (11025.0, 4)):
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
        texts.append(_check_db(f"{fs / 1000:g} kHz osr 2x2 batch {b}", got,
                               want, _exact_db(waves, p, nf)))
    _phase(3, "kernel vs plain, max |diff| dB above / below "
              f"{NULL_DB:g} dB: " + ", ".join(texts)
              + f" (bounds {ATOL_DB} / {NULL_ATOL_DB})")

    p = waterfall_params(FS, 2, 2)
    nf = p.num_frames(n)
    waves, payloads = _synth_slots(dev)
    kw = dict(max_candidates=MAX_CANDIDATES, min_score=MIN_SCORE,
              max_iterations=BP_ITERATIONS)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    res = decode_slots(waves, p, nf, chunk=CHUNK, bp_chunk=BP_CHUNK, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = _counter("k1.launches")
    k5_std_launches = _counter("k5.launches")
    k7_launches = _counter("k7.launches")
    k8_launches = _counter("k8.launches")
    k9_launches = _counter("k9.launches")
    if launches != BATCH // CHUNK or k5_std_launches != BATCH // CHUNK \
            or k8_launches != BATCH // CHUNK \
            or k9_launches != BATCH // CHUNK:
        raise RuntimeError(f"waterfall / sync / LLR / top-K kernels launched"
                           f" {launches} / {k5_std_launches} / {k8_launches} "
                           f"/ {k9_launches} times, want {BATCH // CHUNK}")
    if k7_launches != BATCH // BP_CHUNK:
        raise RuntimeError(f"BP + CRC kernel launched {k7_launches} times, "
                           f"want one a BP group, {BATCH // BP_CHUNK}")
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
              f"sync kernel launches {k5_std_launches}, top-K kernel "
              f"launches {k9_launches}, LLR kernel "
              f"launches {k8_launches}, BP + CRC kernel launches "
              f"{k7_launches}, "
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
    lib_text = _check_library(b16, p, nf, box=False)
    kernel_ms, plain_ms, plain_ev, lib_ms = _kernel_vs_plain_ms(
        lambda: wc.block_waterfall_tf_fused_batch(b16, p, nf, consts),
        lambda: wc.block_waterfall_tf_fused_batch_plain(b16, p, nf, consts),
        "waterfall", reps, kernels=2,
        library=lambda: _library_waterfall(b16, p, nf))
    bound = _waterfall_bound(p, CHUNK, n, box=False)
    ctas, waves_k1 = _waterfall_grid(p, CHUNK, box=False)
    # K2's geometry (20 kHz osr 2x2, where the TPU streams weight strips),
    # driven through decode_slots and then timed
    p20 = waterfall_params(20000.0, 2, 2)
    w20, payloads20 = _synth_slots(dev, 20000.0, 4, 20)
    nf20 = p20.num_frames(w20.shape[1])
    torch.cuda.synchronize()
    _reset_counts()
    res20 = decode_slots(w20, p20, nf20, chunk=4, bp_chunk=BP_CHUNK, **kw)
    torch.cuda.synchronize()
    k2_launches = _counter("k1.launches")
    k7_20 = _counter("k7.launches")
    k8_20 = _counter("k8.launches")
    k9_20 = _counter("k9.launches")
    sets20 = _decode_sets(res20, 4)
    decoded20 = sum(bytes(payloads20[b]) in {s[0] for s in sets20[b]}
                    for b in range(4))
    if k2_launches != 1 or k7_20 != 1 or k8_20 != 1 or k9_20 != 1 \
            or decoded20 != 4:
        raise RuntimeError(f"decode_slots at 20 kHz: waterfall / BP + CRC "
                           f"/ LLR / top-K kernel launches {k2_launches} / "
                           f"{k7_20} / {k8_20} / {k9_20} (want 1), yield "
                           f"{decoded20}/4")
    lib20_text = _check_library(w20, p20, nf20, box=False)
    k2_ms, k2_plain_ms, k2_plain_ev, k2_lib_ms = _kernel_vs_plain_ms(
        lambda: wc.block_waterfall_tf_fused_batch(w20, p20, nf20),
        lambda: wc.block_waterfall_tf_fused_batch_plain(w20, p20, nf20),
        "waterfall", reps, kernels=2,
        library=lambda: _library_waterfall(w20, p20, nf20))
    k2_bound = _waterfall_bound(p20, 4, w20.shape[1], box=False)
    k2_ctas, k2_waves = _waterfall_grid(p20, 4, box=False)
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
    _phase(6, f"[{smi}] waterfall batch {CHUNK} at {FS / 1000:g} kHz "
              f"(pre-pass + kernel, {ctas} thread blocks, {waves_k1:.2f} "
              f"waves): kernel {kernel_ms:.4f} ms ({tflops:.1f} TFLOP/s of "
              f"DFT, bound {bound[0]:.4f} ms by {bound[1]}), "
              f"plain {plain_ms:.4f} ms ({plain_ev} device events per "
              f"call), torch.stft yardstick {lib_ms:.4f} ms ({lib_text}); "
              f"decode_slots on 4 slots at 20 kHz: yield "
              f"{decoded20}/4, waterfall kernel launches {k2_launches}, LLR "
              f"kernel launches {k8_20}, top-K kernel launches {k9_20}, "
              f"BP + CRC kernel launches {k7_20}; "
              f"there batch 4 ({k2_ctas} thread blocks, {k2_waves:.2f} "
              f"waves) kernel {k2_ms:.4f} ms (bound {k2_bound[0]:.4f} ms by "
              f"{k2_bound[1]}), plain "
              f"{k2_plain_ms:.4f} ms ({k2_plain_ev} device events per call),"
              f" torch.stft yardstick {k2_lib_ms:.4f} ms ({lib20_text}) "
              f"(device time over {reps} warm launches, min of 2 counted "
              f"windows); decode_slots "
              f"batch {BATCH}: {BATCH / e2e_s:.1f} slots/s "
              f"({e2e_s * 1e3:.1f} ms per batch, mean of {reps_e2e}); "
              f"peak memory {peak_mib:.1f} MiB")

    _, _, k5_deep_launches, deep_kernels = _deep_phases(dev, smi, waves,
                                                        payloads)
    sync_diffs, chunks, captures = _sync_phase(dev, kl.log)
    k6_launches, _ = _api_phase(dev)
    kt = _time_phase(dev, smi, chunks, captures, waves)
    k4_beacon, k6_beacon = _beacon_phase(dev, smi)
    deep_kernels[1]["launches"] += k4_beacon
    k6_launches += k6_beacon
    for phase in (_channel_phase, _stream_phase, _cli_phase,
                  _parallel_phase, _soak_phase):
        k4_new, k6_new = phase(dev, smi)
        deep_kernels[1]["launches"] += k4_new
        k6_launches += k6_new
    bp_kernel = _bp_phase(dev, smi, waves, kl.log, k7_launches)
    llr_kernel = _llr_phase(dev, smi, waves, kl.log, k8_launches)
    topk_kernel = _topk_phase(dev, smi, waves, kl.log, k9_launches)
    k5_err = max(v for k, v in sync_diffs.items() if k.startswith("K5"))
    k6_err = max(v for k, v in sync_diffs.items() if k.startswith("K6"))

    print(json.dumps({"kernels": [{
        "name": "waterfall_tf", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": errs[FS], "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
        "library_ms": lib_ms}, {
        "name": "waterfall_tf_strips_geometry", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": K2_REPLACES,
        "launches": k2_launches, "max_abs_err": errs[20000.0],
        "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1], "library_ms": k2_lib_ms}] + deep_kernels + [{
        "name": "sync_scores_tf", "route": "cuda", "source": SYNC_SOURCE,
        "replaces": K5_REPLACES, "launches": k5_std_launches
        + k5_deep_launches, "max_abs_err": k5_err,
        "ms": kt["K5 DEEP"][0], "plain_ms": kt["K5 DEEP"][1],
        "bound_ms": kt["K5 DEEP"][3][0], "bound_by": kt["K5 DEEP"][3][1],
        "library_ms": None, "library_note": NO_LIBRARY["sync_scores"]}, {
        "name": "sync_scores", "route": "cuda", "source": SYNC_SOURCE,
        "replaces": K6_REPLACES, "launches": k6_launches,
        "max_abs_err": k6_err, "ms": kt["K6 DEEP"][0],
        "plain_ms": kt["K6 DEEP"][1], "bound_ms": kt["K6 DEEP"][3][0],
        "bound_by": kt["K6 DEEP"][3][1], "library_ms": None,
        "library_note": NO_LIBRARY["sync_scores"]}, bp_kernel,
        llr_kernel, topk_kernel]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
