"""End-to-end satellite FT8 beacon demo — every subsystem in one flow.

A ground station receives a LEO cubesat's FT8 beacon (one fixed message,
repeated every 15-s cycle) through the real pass geometry:

    message text --> payload --> GFSK baseband           (protocol, ops.gfsk)
    TLE --> pass prediction --> per-sample Doppler       (channel)
    Doppler + AWGN applied on the device                 (channel.doppler)
    RX: model-based linear compensation + decimation     (channel.doppler)
        per-cycle residual drift correction              (beacon.drift)
        R-cycle noncoherent stack + known-call AP decode (demod.stack)
        below decode reach: known-payload detection      (beacon.detect)

Run:  python -m ft8_demodulator_tpu_torch.examples.satellite_beacon_demo
      [--esn0 -14] [--cycles 4] [--seed 0]

Port of ``examples/satellite_beacon_demo.py``.  It runs on the card;
``FT8_PLATFORM=cpu`` routes it to the CPU.  The noise comes from a
``torch.Generator`` seeded by ``--seed`` (drawn on the CPU, so the card
and the CPU see the same capture).  :func:`transmit` makes the noisy
capture and :func:`receive` is the RX half, a function of that capture.

The default SNR sits between the single-cycle and stacked decode cliffs,
so the output shows blind single-cycle decoding failing while the
model-compensated stack with the known-call AP hypothesis succeeds.
Raise --esn0 to ~0 to watch the blind path succeed too.
"""

from __future__ import annotations

import argparse
import datetime
import sys
import time

import numpy as np
import torch

from ..beacon import (correct_frequency_drift, detect_known_payload,
                      track_known_payload)
from ..channel import (Channel, add_complex_awgn, apply_doppler_physical,
                       compensate_linear_doppler_physical, decimate)
from ..channel import geodesy as geo
from ..demod import decode_ft8_stacked
from ..demod.decode import decode_ft8_message
from ..ops.gfsk import ft8_baseband
from ..protocol import pack_message, unpack_message
from ..utils.device import platform_device

STATION = {"name": "Delft", "latitude_deg": 51.9989,
           "longitude_deg": 4.3736, "altitude_m": 0.0}
TLE = {
    "name": "STARLINK-1030",
    "TLE_line1": "1 44735U 19074Y   24151.67073227  .00005623  00000+0"
                 "  39580-3 0  9994",
    "TLE_line2": "2 44735  53.0540 235.6876 0001395  85.6354 274.4795"
                 " 15.06429209250797",
}
BEACON_CALL = "PI4THD"
MESSAGE = f"CQ {BEACON_CALL} JO22"
FC_HZ = 437e6                 # UHF cubesat beacon
FS_RF = 10000.0               # capture rate
DECIM = 5                     # -> 2 kHz decode rate
CYCLE_S = 15.0
F0_HZ = 500.0                 # mid-band: residual Doppler never nears DC


def predict_pass_doppler(cycles: int, fs: float):
    """Predict the best pass of the demo scenario and return its Doppler.

    Returns (doppler_hz (cycles*15s*fs,), pass_info string).
    """
    channel = Channel(STATION, TLE)
    epoch = datetime.datetime(2024, 5, 31, 0, 0, 0)
    passes = channel.satellite_overhead_time_prediction(
        epoch, epoch + datetime.timedelta(days=1), 30.0)
    t_enter, duration, max_elev = passes[0]
    t0 = t_enter + duration / 2 - datetime.timedelta(
        seconds=cycles * CYCLE_S / 2)       # centre of the best pass
    n = cycles * int(CYCLE_S * fs)
    jd0 = float(geo.datetime_to_jd(t0))
    jd = jd0 + np.arange(n) / fs / 86400.0
    doppler = channel.normalized_doppler_by_ecef_jd(jd) * FC_HZ
    info = (f"{t_enter} UTC for {duration} (max elevation "
            f"{max_elev:.0f} deg); capture at {t0}")
    return doppler, info


def transmit(cycles: int, esn0: float, seed: int, doppler,
             device="cuda") -> torch.Tensor:
    """The beacon at the start of every 15-s cycle, through the physical
    (integrated-phase) Doppler channel, plus complex AWGN at ``esn0`` from
    ``torch.Generator`` seeded by ``seed``: (n, 2) float32 [re, im] on
    ``device``."""
    payload = pack_message(MESSAGE)
    bb = ft8_baseband(payload, FS_RF, F0_HZ,
                      device=device).cpu().numpy().astype(np.complex128)
    n_cycle = int(CYCLE_S * FS_RF)
    tx = np.zeros(cycles * n_cycle, np.complex128)
    for c in range(cycles):
        tx[c * n_cycle: c * n_cycle + len(bb)] = bb
    ri = np.stack([tx.real, tx.imag], -1).astype(np.float32)
    # physical integrated-phase Doppler (channel/doppler.py): the
    # reference's f_d*t phase convention amplifies partial-compensation
    # residuals by absolute capture time over a multi-cycle capture
    shifted = apply_doppler_physical(ri, doppler, FS_RF, device=device)
    gen = torch.Generator().manual_seed(seed)
    return add_complex_awgn(shifted, gen, esn0)


def receive(noisy, doppler, cycles: int, device="cuda",
            out=print) -> dict:
    """The RX half on the noisy (n, 2) [re, im] capture: path A (linear
    compensation + blind drift correction, one cycle), path B (the
    predicted Doppler removed, the R-cycle stack with coherent and the
    known-call AP decode), known-payload detection and coherent tracking.
    Prints through ``out``; returns {"single", "rows", "dets", "fix",
    "stack"}."""
    payload = pack_message(MESSAGE)
    n = cycles * int(CYCLE_S * FS_RF)

    # ---- RX path A (no TLE): linear compensation + blind drift correction -
    k = np.arange(n)
    slope, intercept = np.polyfit(k, doppler, 1)
    comp_a = compensate_linear_doppler_physical(
        noisy, float(slope), float(intercept), FS_RF, device=device)
    down_a = decimate(comp_a, DECIM).cpu().numpy()
    fs = FS_RF / DECIM
    m_cycle = int(CYCLE_S * fs)
    seg0 = down_a[:m_cycle]
    z0 = seg0[..., 0].astype(np.complex128) + 1j * seg0[..., 1]
    zc0, rate = correct_frequency_drift(z0, fs, device=device)
    single = decode_ft8_message(zc0.astype(np.complex64), fs, min_score=1.0,
                                use_osd=True, mf_first=True, ap=BEACON_CALL,
                                device=device)
    out(f"path A (blind) : cycle-0 residual drift {rate * fs:+.2f} Hz/s "
        f"corrected, {len(single)} decode(s) single-cycle"
        + ("" if single else
           " (blind correction + one cycle cannot reach this SNR)"))

    # ---- RX path B (TLE known): full model compensation + stack + AP ------
    comp_b = apply_doppler_physical(noisy, -np.asarray(doppler), FS_RF,
                                    device=device)
    down_b = decimate(comp_b, DECIM).cpu().numpy()
    stack = np.stack([down_b[c * m_cycle: (c + 1) * m_cycle]
                      for c in range(cycles)])
    rows = decode_ft8_stacked(stack, fs, min_score=1.0, use_osd=True,
                              ap=BEACON_CALL, coherent=True, device=device)
    for r in rows:
        out(f"stacked decode : {unpack_message(r.message.payload)!r}  "
            f"t={r.time_sec:.2f}s f={r.freq_hz:.1f}Hz "
            f"snr={r.snr_db:+.1f}dB")

    # ---- below decode reach: detection-only tracking ----------------------
    dets = detect_known_payload(stack, fs, payload, device=device)
    for t, f, z in dets[:1]:
        out(f"known-payload  : track detected at t={t:.2f}s f={f:.1f}Hz "
            f"z={z:.1f} (works ~4 dB past the stacked decode floor)")

    # with the model prior, the coherent tracker holds lock deeper still
    # (and returns a sub-bin frequency fix for the next cycle)
    fix = track_known_payload(stack[0], fs, payload, time_hint_s=0.16,
                              freq_hint_hz=F0_HZ, device=device)
    out(f"coherent track : stat={fix.stat:.1f} "
        f"{'LOCKED' if fix.detected else 'no lock'} at "
        f"f={fix.freq_hz:.2f} Hz (holds to ~-29 dB single-cycle)")
    return {"single": single, "rows": rows, "dets": dets, "fix": fix,
            "stack": stack}


def main(argv=None) -> int:
    argp = argparse.ArgumentParser(
        prog="ft8_demodulator_tpu_torch.examples.satellite_beacon_demo")
    argp.add_argument("--esn0", type=float, default=-14.0,
                      help="signal-to-noise (dB, signal power over total "
                           "complex noise power at the capture rate); the "
                           "default sits between the single-cycle and "
                           "stacked decode cliffs")
    argp.add_argument("--cycles", type=int, default=4)
    argp.add_argument("--seed", type=int, default=0)
    args = argp.parse_args(argv)
    device = platform_device()
    t_start = time.perf_counter()

    payload = pack_message(MESSAGE)
    print(f"beacon message : {MESSAGE!r} -> payload "
          f"{payload.tobytes().hex()}")
    doppler, pass_info = predict_pass_doppler(args.cycles, FS_RF)
    print(f"pass predicted : {pass_info}")
    n = args.cycles * int(CYCLE_S * FS_RF)
    print(f"doppler        : {doppler[0]:+.0f} -> {doppler[-1]:+.0f} Hz "
          f"over {args.cycles} cycles "
          f"({(doppler[-1] - doppler[0]) / (n / FS_RF):+.1f} Hz/s mean)")

    noisy = transmit(args.cycles, args.esn0, args.seed, doppler, device)
    rx = receive(noisy, doppler, args.cycles, device)

    ok = any(bytes(r.message.payload) == payload.tobytes()
             for r in rx["rows"])
    print(f"[{time.perf_counter() - t_start:.1f}s] "
          + ("beacon decoded through the satellite channel"
             if ok else "no decode at this Es/N0 — try a higher --esn0"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
