"""The plain reference's FT8 message codec: standard (i3 = 1) messages and
the a-priori hypotheses of WSJT-X's AP decoding.

A standard message is 77 bits, c28a | r1a | c28b | r1b | R | g15 | i3, most
significant first, packed into 10 bytes with 3 zero bits at the end:

* c28: the tokens DE 0, QRZ 1, CQ 2, and a standard call: 2,063,592 +
  4,194,304 + its six-character field (a digit third, a leading space
  where the call's digit is second) in the mixed radix 37 x 36 x 10 x 27^3;
* r1a, r1b: the /R suffix bits (0: the traffic sends no suffix);
* R and g15: a four-character Maidenhead grid (R 0), a signal report
  -30..+32 dB as 32,400 + 35 + report (R 1 for an "R-nn" acknowledgement),
  or 32,400 + 2 / 3 / 4 for RRR / RR73 / 73;
* i3 = 1.

:func:`ap_hypotheses` gives the six AP types of the WSJT-X 2.6 User Guide
("AP decoding"), a1 CQ ? ?, a2 MyCall ? ?, a3 MyCall DxCall ?, and
MyCall DxCall with RRR, RR73 or 73: per type the 77 values and the mask of
the bits it fixes (a1: c28a = CQ and r1a; a2: c28a = MyCall and r1a; a3:
both calls and their r1 bits; the last three all 77 bits; every type also
i3 = 1).

Departures from the published description: the last three types come in
the order RRR, RR73, 73 (the User Guide lists RRR, 73, RR73); every type
is tried on every candidate, where WSJT-X picks the types by the QSO's
progress.  Neither changes a decode that passes the CRC: two hypotheses
that both pass fix different bits, so they give the same codeword or the
CRC tells them apart.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

__all__ = ["pack", "unpack", "ap_hypotheses", "is_standard_call"]

_A1 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_A2 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_A3 = "0123456789"
_A4 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_NTOKENS = 2063592
_MAX22 = 4194304
_MAXGRID4 = 32400
_TOKENS = {"DE": 0, "QRZ": 1, "CQ": 2}
_EXCHANGE = {"RRR": 2, "RR73": 3, "73": 4}


def _field6(call: str) -> str | None:
    """A standard call in its six-character field, or None."""
    if len(call) >= 3 and call[2] in _A3:
        c6 = call
    elif 2 <= len(call) <= 5 and call[1] in _A3:
        c6 = " " + call
    else:
        return None
    if len(c6) > 6:
        return None
    c6 = c6.ljust(6)
    ok = (c6[0] in _A1 and c6[1] in _A2 and c6[2] in _A3
          and all(ch in _A4 for ch in c6[3:])
          and any(ch.isalpha() for ch in c6))
    return c6 if ok else None


def is_standard_call(call: str) -> bool:
    return _field6(call) is not None


def _c28(token: str) -> int:
    if token in _TOKENS:
        return _TOKENS[token]
    c6 = _field6(token)
    if c6 is None:
        raise ValueError(f"{token!r} is no standard call")
    n = _A1.index(c6[0])
    n = n * 36 + _A2.index(c6[1])
    n = n * 10 + _A3.index(c6[2])
    for ch in c6[3:]:
        n = n * 27 + _A4.index(ch)
    return _NTOKENS + _MAX22 + n


def _call(c28: int) -> str:
    for token, v in _TOKENS.items():
        if c28 == v:
            return token
    n = c28 - _NTOKENS - _MAX22
    if n < 0:
        raise ValueError(f"c28 {c28} is no standard call")
    out = []
    for radix, alphabet in ((27, _A4), (27, _A4), (27, _A4), (10, _A3),
                            (36, _A2)):
        out.append(alphabet[n % radix])
        n //= radix
    out.append(_A1[n])
    return "".join(reversed(out)).strip()


def _g15(rest: list[str]) -> tuple[int, int]:
    """The tokens after the calls -> (g15, R bit)."""
    if not rest:
        return _MAXGRID4 + 1, 0
    if len(rest) != 1:
        raise ValueError(f"no standard exchange: {rest!r}")
    t = rest[0]
    if t in _EXCHANGE:
        return _MAXGRID4 + _EXCHANGE[t], 0
    if len(t) == 4 and "A" <= t[0] <= "R" and "A" <= t[1] <= "R" \
            and t[2:].isdigit():
        return (ord(t[0]) - 65) * 1800 + (ord(t[1]) - 65) * 100 \
            + int(t[2:]), 0
    r_bit = int(t.startswith("R"))
    report = t[r_bit:]
    if len(report) == 3 and report[0] in "+-" and report[1:].isdigit() \
            and -30 <= int(report) <= 32:
        return _MAXGRID4 + 35 + int(report), r_bit
    raise ValueError(f"no standard exchange: {t!r}")


def _exchange(g15: int, r_bit: int) -> str:
    if g15 <= _MAXGRID4:
        return (chr(65 + g15 // 1800) + chr(65 + g15 // 100 % 18)
                + f"{g15 % 100:02d}")
    irpt = g15 - _MAXGRID4
    if irpt == 1:
        return ""
    names = {v: k for k, v in _EXCHANGE.items()}
    if irpt in names:
        return names[irpt]
    return ("R" if r_bit else "") + f"{irpt - 35:+03d}"


def _bits(value: int, width: int) -> list[int]:
    return [(value >> (width - 1 - i)) & 1 for i in range(width)]


def pack(text: str) -> bytes:
    """'CALL1 CALL2 [exchange]' (CALL1 may be CQ, DE or QRZ) -> the 10
    payload bytes of the standard message."""
    tokens = text.upper().split()
    if len(tokens) not in (2, 3):
        raise ValueError(f"no standard message: {text!r}")
    g15, r_bit = _g15(tokens[2:])
    v = _c28(tokens[0])
    v = (v << 1) << 28 | _c28(tokens[1])
    v = ((v << 1) << 1 | r_bit) << 15 | g15
    v = v << 3 | 1
    return (v << 3).to_bytes(10, "big")


def unpack(payload: bytes) -> str:
    """10 payload bytes of a standard message -> its text."""
    v = int.from_bytes(bytes(payload), "big") >> 3
    if v & 7 != 1:
        raise ValueError("not a standard (i3 = 1) message")
    g15 = (v >> 3) & 0x7FFF
    r_bit = (v >> 18) & 1
    b = (v >> 20) & 0xFFFFFFF
    a = (v >> 49) & 0xFFFFFFF
    ex = _exchange(g15, r_bit)
    return " ".join(t for t in (_call(a), _call(b), ex) if t)


def ap_hypotheses(my_call: str, dx_call: str
                  ) -> tuple[np.ndarray, np.ndarray]:
    """The six AP types of a station ``my_call`` in a QSO with ``dx_call``
    -> (values (6, 77) uint8, mask (6, 77) bool): a1 CQ ? ?, a2 MyCall ? ?,
    a3 MyCall DxCall ?, MyCall DxCall RRR / RR73 / 73."""
    values = np.zeros((6, 77), np.uint8)
    mask = np.zeros((6, 77), bool)
    first = [_c28("CQ"), _c28(my_call.upper())] + [_c28(my_call.upper())] * 4
    for h in range(6):
        values[h, 0:28] = _bits(first[h], 28)
        mask[h, 0:29] = True                        # c28a, r1a = 0
        if h >= 2:
            values[h, 29:57] = _bits(_c28(dx_call.upper()), 28)
            mask[h, 29:58] = True                   # c28b, r1b = 0
        if h >= 3:
            g15 = _MAXGRID4 + (2, 3, 4)[h - 3]      # RRR, RR73, 73
            values[h, 59:74] = _bits(g15, 15)
            mask[h, 58:74] = True                   # R = 0, g15
        values[h, 74:77] = (0, 0, 1)                # i3 = 1
        mask[h, 74:77] = True
    return values, mask
