"""The port's CLI against the JAX package's, on the same WAV files.

Both ``main``s run in this process with ``FT8_PLATFORM=cpu``; for every
command the port's standard output equals JAX's byte for byte: the plain,
``json`` and ``alltxt`` formats, ``Metrics:`` and the info lines.  Usage
errors exit with the same codes and error lines (the program name apart).
One named exception: the ``Metrics:`` line's full-precision scores.
``--tx`` writes a WAV within 1e-4 of JAX's, with the same printed lines.
"""

import json

import numpy as np
import pytest

from ft8_demodulator_tpu import cli as jcli
from ft8_demodulator_tpu.io import read_wave_file, write_wave_file
from ft8_demodulator_tpu.ops.gfsk import ft8_passband
from ft8_demodulator_tpu_torch import cli as tcli

FS = 2000.0
SCORE_ATOL = 1e-4


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("FT8_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def wavs(tmp_path_factory, goldens):
    """The fixtures of tests/test_cli.py: one 15-s slot, and four 15-s
    cycles of one repeating transmission at -17 dB."""
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(1234)
    wave = np.asarray(ft8_passband(goldens["p1_payload"], FS, 400.0, 0.0))
    sig = np.zeros(int(FS * 15), np.float32)
    sig[1000: 1000 + len(wave)] = wave
    sig += rng.standard_normal(len(sig)).astype(np.float32) * 0.02
    slot = str(tmp / "t.wav")
    write_wave_file(slot, sig / np.abs(sig).max() * 0.8, FS)

    rng = np.random.default_rng(1234)
    sp = float(np.mean(wave ** 2))
    cyc = np.zeros((4, int(FS * 15)), np.float32)
    cyc[:, 500: 500 + len(wave)] = wave
    cyc += rng.standard_normal(cyc.shape).astype(np.float32) \
        * np.sqrt(sp / 10 ** (-17.0 / 10))
    flat = cyc.reshape(-1)
    beacon = str(tmp / "beacon.wav")
    write_wave_file(beacon, flat / np.abs(flat).max() * 0.8, FS)
    return {"slot": slot, "beacon": beacon}


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _metrics(out):
    lines = out.splitlines()
    at = [i for i, ln in enumerate(lines) if ln.startswith("Metrics: ")]
    m = json.loads(lines[at[0]].removeprefix("Metrics: ")) if at else None
    return [ln for i, ln in enumerate(lines) if i not in at], m


def _same(argv, capsys):
    """The port's stdout equals JAX's.  Named exception: the ``Metrics:``
    line prints best_score and mean_score at full float precision, where
    the two packages' float32 scores differ in the last digits; it is
    parsed, its counts held equal and its scores within SCORE_ATOL."""
    want = _run(jcli.main, argv, capsys)
    got = _run(tcli.main, argv, capsys)
    assert got[0] == want[0] == 0
    if "--metrics" not in argv:
        assert got[1] == want[1]
        return got
    (glines, gm), (wlines, wm) = _metrics(got[1]), _metrics(want[1])
    assert glines == wlines and gm.keys() == wm.keys()
    for k in wm:
        if isinstance(wm[k], float):
            assert abs(gm[k] - wm[k]) <= SCORE_ATOL, k
        else:
            assert gm[k] == wm[k], k
    return got


@pytest.mark.parametrize("flags,decodes", [
    ([], True), (["--min-score", "5"], True),
    (["--min-score", "5", "--metrics"], True), (["--deep"], True),
    (["--stream", "--min-score", "5"], True), (["--no-dedup"], True),
    (["--min-score", "99"], False),
    (["--osd", "--mf", "--min-score", "5"], True),
    (["--passes", "2", "--min-score", "5"], True),
    # the blind corrector fits noise on this slot (both packages alike)
    (["--correction", "--min-score", "5"], False),
    (["--correction", "--stream", "--min-score", "5"], False),
    (["--deep", "--coherent", "--ap-calls", "K1ABC W9XYZ", "--mf-refine"],
     True),
    (["--refine-fixes", "--min-score", "5"], True)],
    ids=["default", "min_score", "metrics", "deep", "stream", "no_dedup",
         "nothing", "osd_mf", "passes", "correction", "correction_stream",
         "deepest", "refine_fixes"])
def test_stdout_equals_jax(flags, decodes, wavs, capsys):
    _, out, _ = _same([wavs["slot"]] + flags, capsys)
    assert ("Payload: " in out) == decodes


@pytest.mark.parametrize("fmt", ["json", "alltxt"])
def test_machine_formats_equal_jax(fmt, wavs, capsys):
    _, out, err = _same([wavs["slot"], "--min-score", "5", "--format", fmt],
                        capsys)
    assert "Read " in err and "Read " not in out
    if fmt == "json":
        rows = [json.loads(ln) for ln in out.splitlines()]
        assert rows and all({"time_sec", "freq_hz", "snr_db", "message"}
                            <= set(r) for r in rows)


@pytest.mark.parametrize("flags", [["--stack", "2"],
                                   ["--stack", "4", "--min-score", "1",
                                    "--osd"]], ids=["stack2", "stack4_osd"])
def test_stack_equals_jax(flags, wavs, capsys):
    _, out, _ = _same([wavs["beacon"]] + flags, capsys)
    assert "Stacked 4 cycles" in out


@pytest.mark.parametrize("argv,code", [
    (["{slot}", "--stream", "--freq-min", "300"], 2),
    (["{slot}", "--stream", "--passes", "2"], 2),
    (["{slot}", "--stack", "4", "--stream"], 2),
    (["{slot}", "--stack", "4", "--passes", "2"], 2),
    (["--tx", "CQ K1ABC FN42", "--stream", "{out}"], 2),
    (["{slot}", "--format", "xml"], 2),
    (["/nonexistent/x.wav"], 1),
    (["{slot}", "--stack", "4"], 1),
    (["--tx", "THIS ONE IS FAR TOO LONG TO PACK", "{out}"], 1),
    (["--tx", "CQ K1ABC FN42", "--tx-start", "-1", "{out}"], 1),
])
def test_usage_errors_and_exit_codes_equal_jax(argv, code, wavs, tmp_path,
                                               capsys):
    argv = [a.format(slot=wavs["slot"], out=str(tmp_path / "o.wav"))
            for a in argv]
    results = []
    for main in (jcli.main, tcli.main):
        capsys.readouterr()
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
        cap = capsys.readouterr()
        # the usage text wraps at the program name's width: the error
        # line (its last line) is compared
        last = cap.err.strip().splitlines()[-1]
        results.append((rc, cap.out,
                        last.replace("ft8_demodulator_tpu_torch",
                                     "ft8_demodulator_tpu")))
    assert results[1] == results[0]
    assert results[0][0] == code


@pytest.mark.parametrize("snr", [None, "0"])
def test_tx_writes_jaxs_wav(snr, tmp_path, capsys):
    paths = {k: str(tmp_path / f"{k}.wav") for k in ("jax", "torch")}
    argv = ["--tx", "CQ K1ABC FN42", "--fs", "2000", "--f0", "500",
            "--tx-seed", "7"] + ([] if snr is None else ["--tx-snr", snr])
    outs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        rc, out, _ = _run(main, argv + [paths[name]], capsys)
        assert rc == 0
        outs[name] = out.replace(paths[name], "OUT")
    assert outs["torch"] == outs["jax"]
    assert "Message: CQ K1ABC FN42" in outs["torch"].splitlines()
    a, fa = read_wave_file(paths["jax"])
    b, fb = read_wave_file(paths["torch"])
    assert fa == fb and a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-4)
    # and the port decodes its own file as JAX does
    _same([paths["torch"], "--min-score", "5"], capsys)


def test_deep_preset_keeps_explicit_flags(wavs, capsys, monkeypatch):
    """--deep fills only unset options: an explicit --max-candidates wins."""
    import ft8_demodulator_tpu_torch.demod as tdemod

    seen = {}
    orig = tdemod.decode_ft8_message

    def spy(*a, **kw):
        seen.update(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(tdemod, "decode_ft8_message", spy)
    assert tcli.main([wavs["slot"], "--deep", "--max-candidates", "24",
                      "--bins-per-tone", "2", "--steps-per-symbol",
                      "2"]) == 0
    assert seen["max_candidates"] == 24 and seen["bins_per_tone"] == 2
    assert seen["min_score"] == 1.0 and seen["use_osd"] is True
    assert str(seen["device"]) == "cpu"


def test_without_a_card_an_unset_platform_raises(wavs, monkeypatch):
    import torch

    monkeypatch.delenv("FT8_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="FT8_PLATFORM=cpu"):
        tcli.main([wavs["slot"]])


def test_parser_is_jaxs():
    """The same flags, defaults and help (the program name and the NaN
    flag's wording apart)."""
    jp, tp = jcli.build_parser(), tcli.build_parser()
    ja = {a.dest: (a.option_strings, a.default, a.help) for a in jp._actions}
    ta = {a.dest: (a.option_strings, a.default, a.help) for a in tp._actions}
    assert ja.keys() == ta.keys()
    for k in ja:
        if k != "debug_nans":
            assert ta[k] == ja[k], k
