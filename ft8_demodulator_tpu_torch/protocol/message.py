"""FT8 message text <-> 77-bit payload codec (WSJT-X packjt77 semantics).

Beyond-reference layer: the reference framework only ever handles raw
10-byte payloads (golden payload in src/tests/generator/test_crc.py;
from_wave.py prints payload hex, src/tests/demodulator/from_wave.py:222-229).
Real FT8 traffic is text — "CQ K1ABC FN42" — so a user switching from
WSJT-X needs the pack/unpack layer to generate beacons and read decodes.

This codec is host-side pure Python by design: message packing is string
processing, not a device op; the packed 10-byte payload is what enters the
encode/decode pipelines.

A copy of ``ft8_demodulator_tpu/protocol/message.py`` with the same names
and behaviour, so that the port loads nothing of the JAX package
(``tests/test_torch_message.py`` holds the two equal).  Its callsign hash
table and the context variable that selects the active one are this
package's own: hashes remembered by one package do not resolve in the
other.

Supported message types (i3 = last 3 payload bits; n3 = 3 bits before it
when i3 = 0):

- 0.0 free text    — 13 chars from a 42-char alphabet, right-justified
- 0.1 DXpedition   — "K1ABC RR73; W9XYZ <KH1/KH7Z> -08": c28 c28 h10 r5
- 0.5 telemetry    — 71 bits as up to 18 hex digits (first digit <= 7)
- 1   standard     — c28 r1 c28 r1 R1 g15: two calls + grid/report, /R
- 2   standard /P  — same layout, suffix means /P (EU VHF convention)
- 0.3 Field Day   — "WA9XYZ KA1ABC R 16A EMA": c28 c28 R1 n4 k3 S7 with
                     transmitters 1-16 (exchange <ntx><class> <section>)
- 0.4 Field Day   — same layout, transmitters 17-32
- 3   RTTY Roundup — "TU; W9XYZ K1ABC R 579 MA": t1 c28 c28 R1 r3 s13;
                     exchange is a serial number (0001-7999, table-free)
                     or a US state / Canadian province from the 65-entry
                     contest multiplier table
- 4   nonstandard  — one full 11-char base-38 call + 12-bit hash of the
                     other; RRR/RR73/73 exchange only
- 5   EU VHF      — "<G4ABC> <PA9XYZ> R 570007 JO22DB": h12 h22 R1 r3
                     s11 g25 (hashed calls, RST+serial, 6-char locator)

Only the reserved/unused subtypes (0.2, 0.6, 0.7, i3=6/7) raise
UnsupportedMessageError on unpack so callers can fall back to payload
hex.  Every implemented type is covered by pack<->unpack roundtrip
property tests; the Field Day section table and RTTY multiplier table
are the published fixed lists (see the sections below).  Hashed
callsigns ("<K1ABC>") resolve through a hash table populated by every
call packed or unpacked — the process-global table by default, or a
session-owned CallsignHashTable passed via the hash_table argument
(sessions persist theirs across checkpoints), exactly like WSJT-X's
rolling hash cache; unknown hashes render as "<...>".
"""

from __future__ import annotations

import contextvars
import re

import numpy as np

__all__ = [
    "CallsignHashTable",
    "UnsupportedMessageError",
    "ap_hypotheses",
    "pack_message",
    "pack_free_text",
    "pack_telemetry",
    "unpack_message",
    "hash_callsign",
    "remember_callsign",
    "clear_hash_table",
    "is_standard_callsign",
]

# Standard-callsign 6-char field alphabets (position-dependent).
_A1 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_A2 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_A3 = "0123456789"
_A4 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_FREETEXT = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ+-./?"
_B38 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ/"

_NTOKENS = 2063592          # DE/QRZ/CQ/CQ nnn/CQ aaaa token space
_MAX22 = 1 << 22            # 22-bit hashed-callsign space
_MAXGRID4 = 32400           # 18*18*10*10 four-char Maidenhead grids
_HASH_MULT = 47055833459    # WSJT-X ihashcall multiplier

_GRID_RE = re.compile(r"^[A-R][A-R][0-9][0-9]$")
_REPORT_RE = re.compile(r"^(R)?([+-][0-9]{2})$")


class UnsupportedMessageError(ValueError):
    """Payload is a valid FT8 type this codec does not implement."""


# ---------------------------------------------------------------------------
# payload bytes <-> 77-bit integer

def _payload_to_int(payload) -> int:
    if isinstance(payload, (bytes, bytearray)):
        payload = np.frombuffer(payload, np.uint8)
    b = np.asarray(payload, dtype=np.uint8).reshape(-1)
    if b.size != 10:
        raise ValueError("payload must be 10 bytes")
    return int.from_bytes(b.tobytes(), "big") >> 3

def _int_to_payload(v: int) -> np.ndarray:
    if not 0 <= v < (1 << 77):
        raise ValueError("payload value out of 77-bit range")
    return np.frombuffer((v << 3).to_bytes(10, "big"), np.uint8).copy()


# ---------------------------------------------------------------------------
# callsign hashing (10/12/22-bit), WSJT-X-compatible

class CallsignHashTable:
    """WSJT-X-style rolling hash cache: every callsign packed or unpacked
    is remembered so later "<CALL>" hash-only decodes resolve to text.

    Instances are independent — a session decoding one band does not leak
    resolutions into another.  ``pack_message``/``unpack_message`` use the
    process-global table unless one is passed explicitly; sessions
    (StreamSession/BeaconSession) own one and persist it in checkpoints.
    """

    def __init__(self, calls=()):
        self._by_bits: dict[int, dict[int, str]] = {10: {}, 12: {}, 22: {}}
        for c in calls:
            self.add(c)

    def add(self, call: str) -> None:
        call = call.strip().upper()
        if not call or any(c not in _B38 for c in call) or len(call) > 11:
            return
        for bits in (10, 12, 22):
            self._by_bits[bits][hash_callsign(call, bits)] = call

    def get(self, h: int, bits: int) -> str | None:
        return self._by_bits[bits].get(h)

    def calls(self) -> list[str]:
        """Distinct remembered callsigns, sorted (for serialisation)."""
        return sorted(set(self._by_bits[22].values()))

    def clear(self) -> None:
        for d in self._by_bits.values():
            d.clear()

    def __len__(self) -> int:
        return len(set(self._by_bits[22].values()))


_HASHES = CallsignHashTable()

# Active table for the duration of one pack/unpack call (contextvar so
# nested/threaded use stays isolated); falls back to the global table.
_ACTIVE_HASHES: "contextvars.ContextVar[CallsignHashTable | None]" = \
    contextvars.ContextVar("ft8_torch_active_hash_table", default=None)


def _hashes() -> CallsignHashTable:
    t = _ACTIVE_HASHES.get()
    # explicit None test: an EMPTY session table is falsy (__len__ == 0)
    # but must still shadow the global one
    return _HASHES if t is None else t


def hash_callsign(call: str, bits: int = 22) -> int:
    """WSJT-X rolling callsign hash: top `bits` of 47055833459 * n58.

    n58 is the call left-justified in 11 base-38 chars
    (" 0-9A-Z/").  bits must be 10, 12, or 22.
    """
    if bits not in (10, 12, 22):
        raise ValueError("hash width must be 10, 12, or 22 bits")
    c = call.strip().upper()
    if not 1 <= len(c) <= 11:
        raise ValueError(f"hashable callsign must be 1-11 chars: {call!r}")
    bad = [ch for ch in c if ch not in _B38]
    if bad:
        raise ValueError(f"callsign {call!r} has unsupported character(s) "
                         f"{''.join(sorted(set(bad)))!r} (allowed: A-Z, "
                         "0-9, /, space)")
    n58 = 0
    for ch in c.ljust(11):
        n58 = n58 * 38 + _B38.index(ch)
    return ((_HASH_MULT * n58) & ((1 << 64) - 1)) >> (64 - bits)


def remember_callsign(call: str) -> None:
    """Add a call to the hash cache so later "<CALL>" decodes resolve."""
    _hashes().add(call)


def clear_hash_table() -> None:
    _hashes().clear()


# ---------------------------------------------------------------------------
# standard callsign <-> n28

def _align6(call: str) -> str | None:
    """Place a standard call in the 6-char field (3rd char = digit)."""
    if len(call) >= 3 and call[2] in _A3:
        c6 = call
    elif 2 <= len(call) <= 5 and call[1] in _A3:
        c6 = " " + call
    else:
        return None
    if len(c6) > 6:
        return None
    c6 = c6.ljust(6)
    if (c6[0] in _A1 and c6[1] in _A2 and c6[2] in _A3
            and all(ch in _A4 for ch in c6[3:])
            # the 28-bit field admits digit-only values like "73"/"599",
            # but real callsigns contain a letter — without this check a
            # sign-off ("PJ4/K1ABC 73") parses as a second callsign
            and any(ch.isalpha() for ch in c6)):
        return c6
    return None


def is_standard_callsign(call: str) -> bool:
    """True if `call` packs into the 28-bit standard-callsign space."""
    return _align6(call.strip().upper()) is not None


def _std_to_n28(c6: str) -> int:
    n = _A1.index(c6[0])
    n = n * 36 + _A2.index(c6[1])
    n = n * 10 + _A3.index(c6[2])
    for ch in c6[3:]:
        n = n * 27 + _A4.index(ch)
    return n


def _n28_to_std(n: int) -> str:
    out = []
    for _ in range(3):
        out.append(_A4[n % 27]); n //= 27
    out.append(_A3[n % 10]); n //= 10
    out.append(_A2[n % 36]); n //= 36
    out.append(_A1[n])
    return "".join(reversed(out)).strip()


def _pack28(tok: str) -> int | None:
    """One first/second-field token -> c28, or None if unrepresentable."""
    if tok == "DE":
        return 0
    if tok == "QRZ":
        return 1
    if tok == "CQ":
        return 2
    m = re.match(r"^CQ[_ ]([0-9]{3})$", tok)
    if m:
        return 3 + int(m.group(1))
    m = re.match(r"^CQ[_ ]([A-Z]{1,4})$", tok)
    if m:
        w = m.group(1).rjust(4)
        n = 0
        for ch in w:
            n = n * 27 + _A4.index(ch)
        return 1003 + n       # "   A" -> 1004; "ZZZZ" -> 532443
    if tok.startswith("<") and tok.endswith(">"):
        inner = tok[1:-1]
        if inner and inner != "...":
            try:
                h = hash_callsign(inner, 22)
            except ValueError:
                return None        # unhashable chars -> not a call token
            _hashes().add(inner)
            return _NTOKENS + h
        return None
    c6 = _align6(tok)
    if c6 is not None:
        _hashes().add(tok)
        return _NTOKENS + _MAX22 + _std_to_n28(c6)
    return None


def _unpack28(c28: int) -> str:
    if c28 == 0:
        return "DE"
    if c28 == 1:
        return "QRZ"
    if c28 == 2:
        return "CQ"
    if c28 < 1003:
        return f"CQ {c28 - 3:03d}"
    if c28 <= 532443:
        n = c28 - 1003
        w = []
        for _ in range(4):
            w.append(_A4[n % 27]); n //= 27
        return "CQ " + "".join(reversed(w)).strip()
    if c28 < _NTOKENS:
        return "<?>"          # reserved token space (unused by WSJT-X)
    if c28 < _NTOKENS + _MAX22:
        call = _hashes().get(c28 - _NTOKENS, 22)
        return f"<{call}>" if call else "<...>"
    call = _n28_to_std(c28 - _NTOKENS - _MAX22)
    _hashes().add(call)
    return call


# ---------------------------------------------------------------------------
# grid / report field <-> g15

def _pack_g15(rest: list[str]) -> tuple[int, int] | None:
    """Trailing tokens -> (g15, R1-bit), or None if unrepresentable."""
    if not rest:
        return _MAXGRID4 + 1, 0
    if rest[0] == "R" and len(rest) == 2 and _GRID_RE.match(rest[1]):
        g = rest[1]
        return ((ord(g[0]) - 65) * 18 * 100 + (ord(g[1]) - 65) * 100
                + int(g[2:])), 1
    if len(rest) != 1:
        return None
    t = rest[0]
    if _GRID_RE.match(t) and t != "RR73":
        return ((ord(t[0]) - 65) * 18 * 100 + (ord(t[1]) - 65) * 100
                + int(t[2:])), 0
    if t == "RRR":
        return _MAXGRID4 + 2, 0
    if t == "RR73":
        return _MAXGRID4 + 3, 0
    if t == "73":
        return _MAXGRID4 + 4, 0
    m = _REPORT_RE.match(t)
    if m:
        irpt = int(m.group(2)) + 35
        if 5 <= irpt and _MAXGRID4 + irpt < (1 << 15):
            return _MAXGRID4 + irpt, 1 if m.group(1) else 0
    return None


def _unpack_g15(g15: int, r_bit: int) -> str:
    prefix = "R " if r_bit else ""
    if g15 <= _MAXGRID4:
        g = (chr(65 + g15 // 1800) + chr(65 + g15 // 100 % 18)
             + f"{g15 % 100:02d}")
        return prefix + g
    irpt = g15 - _MAXGRID4
    if irpt == 1:
        return ""
    if irpt == 2:
        return "RRR"
    if irpt == 3:
        return "RR73"
    if irpt == 4:
        return "73"
    return ("R" if r_bit else "") + f"{irpt - 35:+03d}"


# ---------------------------------------------------------------------------
# standard (i3 = 1/2) and nonstandard (i3 = 4) packing

def _strip_suffix(tok: str) -> tuple[str, int, int]:
    """-> (base, r1, pflag): strip /R (type 1) or /P (type 2)."""
    if tok.endswith("/R"):
        return tok[:-2], 1, 0
    if tok.endswith("/P"):
        return tok[:-2], 1, 1
    return tok, 0, 0


def _is_nonstd_call(tok: str) -> bool:
    """A full call only the 58-bit base-38 field can carry."""
    if not 3 <= len(tok) <= 11 or any(c not in _B38 for c in tok):
        return False
    if _align6(tok) is not None:
        return False
    return any(c.isalpha() for c in tok) and (
        "/" in tok or any(c.isdigit() for c in tok))


def _try_pack_standard(tokens: list[str]) -> int | None:
    if len(tokens) < 2:
        return None
    # "CQ POTA K1ABC ..." / "CQ 001 ..." merge the modifier into field 1
    if (tokens[0] == "CQ" and len(tokens) >= 3
            and re.match(r"^([A-Z]{1,4}|[0-9]{3})$", tokens[1])
            and _pack28(tokens[2].split("/")[0]
                        if "/" in tokens[2] else tokens[2]) is not None):
        tokens = [f"CQ {tokens[1]}"] + tokens[2:]
    ta, tb, rest = tokens[0], tokens[1], tokens[2:]
    a, r1a, pa = _strip_suffix(ta)
    b, r1b, pb = _strip_suffix(tb)
    c28a, c28b = _pack28(a), _pack28(b)
    if c28a is None or c28b is None:
        return None
    g15r = _pack_g15(rest)
    if g15r is None:
        return None
    g15, r_bit = g15r
    i3 = 2 if (pa or pb) else 1
    if (pa or pb) and (ta.endswith("/R") or tb.endswith("/R")):
        return None
    v = c28a
    v = (v << 1) | r1a
    v = (v << 28) | c28b
    v = (v << 1) | r1b
    v = (v << 1) | r_bit
    v = (v << 15) | g15
    return (v << 3) | i3


def _try_pack_nonstandard(tokens: list[str]) -> int | None:
    if len(tokens) < 2 or len(tokens) > 3:
        return None
    c1 = 1 if tokens[0] == "CQ" else 0
    rest = tokens[2:]
    if c1:
        if rest:
            return None             # "CQ PJ4/K1ABC" carries no exchange
        full_idx, full, other = 0, tokens[1], None
    else:
        calls = tokens[:2]
        nonstd = [i for i, t in enumerate(calls) if _is_nonstd_call(t)]
        if len(nonstd) != 1:
            return None
        full_idx = nonstd[0]
        full = calls[full_idx]
        other = calls[1 - full_idx]
        if other.startswith("<") and other.endswith(">"):
            other = other[1:-1]
        elif not is_standard_callsign(other):
            return None
    if not _is_nonstd_call(full):
        return None
    if not rest:
        r2 = 0
    elif len(rest) == 1 and rest[0] in ("RRR", "RR73", "73"):
        r2 = {"RRR": 1, "RR73": 2, "73": 3}[rest[0]]
    else:
        return None
    if c1 or other in ("", "..."):
        h12 = 0
    else:
        try:
            h12 = hash_callsign(other, 12)
        except ValueError:
            return None
    if other and other != "...":
        _hashes().add(other)
    _hashes().add(full)
    n58 = 0
    for ch in full.ljust(11):
        n58 = n58 * 38 + _B38.index(ch)
    # h1: 1 when the hashed call is the SECOND field (full call first)
    h1 = 1 if (not c1 and full_idx == 0) else 0
    v = h12
    v = (v << 58) | n58
    v = (v << 1) | h1
    v = (v << 2) | r2
    v = (v << 1) | c1
    return (v << 3) | 4


def _unpack_standard(v: int, i3: int) -> str:
    g15 = (v >> 3) & 0x7FFF
    r_bit = (v >> 18) & 1
    r1b = (v >> 19) & 1
    c28b = (v >> 20) & ((1 << 28) - 1)
    r1a = (v >> 48) & 1
    c28a = (v >> 49) & ((1 << 28) - 1)
    sfx = "/P" if i3 == 2 else "/R"
    a = _unpack28(c28a) + (sfx if r1a else "")
    b = _unpack28(c28b) + (sfx if r1b else "")
    tail = _unpack_g15(g15, r_bit)
    return " ".join(x for x in (a, b, tail) if x)


def _unpack_nonstandard(v: int) -> str:
    c1 = (v >> 3) & 1
    r2 = (v >> 4) & 3
    h1 = (v >> 6) & 1
    n58 = (v >> 7) & ((1 << 58) - 1)
    h12 = (v >> 65) & 0xFFF
    chars = []
    for _ in range(11):
        chars.append(_B38[n58 % 38]); n58 //= 38
    full = "".join(reversed(chars)).strip()
    _hashes().add(full)
    if c1:
        parts = ["CQ", full]
    else:
        other = _hashes().get(h12, 12)
        hashed = f"<{other}>" if other else "<...>"
        parts = [full, hashed] if h1 else [hashed, full]
    tail = {0: "", 1: "RRR", 2: "RR73", 3: "73"}[r2]
    if tail:
        parts.append(tail)
    return " ".join(parts)


# ---------------------------------------------------------------------------
# DXpedition mode (i3 = 0, n3 = 1): c28 c28 h10 r5
#
# "K1ABC RR73; W9XYZ <KH1/KH7Z> -08" — Fox acknowledges K1ABC (RR73) and
# simultaneously reports -08 to W9XYZ; the Fox's own (often nonstandard)
# call rides as a 10-bit hash.  Report r5 encodes even dB values
# -30..+32 as (rpt + 30) / 2.

def _try_pack_dxpedition(tokens: list[str]) -> int | None:
    if len(tokens) != 5 or tokens[1] != "RR73;":
        return None
    c28a = _pack28(tokens[0])
    c28b = _pack28(tokens[2])
    fox = tokens[3]
    if not (fox.startswith("<") and fox.endswith(">") and len(fox) > 2):
        return None
    m = re.match(r"^([+-][0-9]{2})$", tokens[4])
    if c28a is None or c28b is None or m is None:
        return None
    rpt = int(m.group(1))
    if not -30 <= rpt <= 32 or rpt % 2:
        return None
    inner = fox[1:-1]
    if inner == "...":
        return None
    try:
        h10 = hash_callsign(inner, 10)
    except ValueError:
        return None
    _hashes().add(inner)
    v = c28a
    v = (v << 28) | c28b
    v = (v << 10) | h10
    v = (v << 5) | ((rpt + 30) // 2)
    return (v << 6) | (1 << 3)                  # n3 = 1, i3 = 0


def _unpack_dxpedition(f71: int) -> str:
    r5 = f71 & 31
    h10 = (f71 >> 5) & 0x3FF
    c28b = (f71 >> 15) & ((1 << 28) - 1)
    c28a = (f71 >> 43) & ((1 << 28) - 1)
    fox = _hashes().get(h10, 10)
    hashed = f"<{fox}>" if fox else "<...>"
    return (f"{_unpack28(c28a)} RR73; {_unpack28(c28b)} "
            f"{hashed} {2 * r5 - 30:+03d}")


# ---------------------------------------------------------------------------
# ARRL RTTY Roundup (i3 = 3): t1 c28 c28 R1 r3 s13
#
# "TU; W9XYZ K1ABC R 579 MA" — t1 flags the leading "TU;", the report is
# RST 529..599 (r3 = strength digit - 2), and the 13-bit exchange s13 is
# either a serial number 1..7999 (rendered 4 digits zero-padded) or
# 8000 + i for the i-th (1-based) entry of the contest multiplier table:
# the 50 US states in conventional (name-alphabetical) order, 14 Canadian
# provinces/territories, then DC — WSJT-X packjt77's table.  The serial
# form is table-free; only state/province text depends on the ordering.

_RTTY_MULTS = (
    "AL AK AZ AR CA CO CT DE FL GA HI ID IL IN IA KS KY LA ME MD "
    "MA MI MN MS MO MT NE NV NH NJ NM NY NC ND OH OK OR PA RI SC "
    "SD TN TX UT VT VA WA WV WI WY "
    "NB NS QC ON MB SK AB BC NWT NF LB NU YT PEI DC").split()

_RTTY_REPORT_RE = re.compile(r"^5([2-9])9$")


def _try_pack_rtty_ru(tokens: list[str]) -> int | None:
    tokens = list(tokens)          # never mutate the caller's token list
    t1 = 0
    if tokens and tokens[0] == "TU;":
        t1 = 1
        tokens = tokens[1:]
    if len(tokens) not in (4, 5):
        return None
    if len(tokens) == 5:
        if tokens[2] != "R":
            return None
        r_bit = 1
        del tokens[2:3]
    else:
        r_bit = 0
    c28a, c28b = _pack28(tokens[0]), _pack28(tokens[1])
    m = _RTTY_REPORT_RE.match(tokens[2])
    if c28a is None or c28b is None or m is None:
        return None
    r3 = int(m.group(1)) - 2
    exch = tokens[3]
    if exch in _RTTY_MULTS:
        s13 = 8000 + 1 + _RTTY_MULTS.index(exch)
    elif len(exch) == 4 and exch.isdigit() and 1 <= int(exch) <= 7999:
        # serials only in their canonical zero-padded 4-digit form (WSJT-X
        # renders them %04d, and only packs type 3 in contest mode): a
        # short free text like "DE DE 529 01" must round-trip verbatim as
        # free text, not normalise to "DE DE 529 0001" (advisor r2)
        s13 = int(exch)
    else:
        return None
    v = t1
    v = (v << 28) | c28a
    v = (v << 28) | c28b
    v = (v << 1) | r_bit
    v = (v << 3) | r3
    v = (v << 13) | s13
    return (v << 3) | 3


def _unpack_rtty_ru(v: int) -> str:
    s13 = (v >> 3) & 0x1FFF
    r3 = (v >> 16) & 7
    r_bit = (v >> 19) & 1
    c28b = (v >> 20) & ((1 << 28) - 1)
    c28a = (v >> 48) & ((1 << 28) - 1)
    t1 = (v >> 76) & 1
    if 1 <= s13 <= 7999:
        exch = f"{s13:04d}"
    elif 8001 <= s13 <= 8000 + len(_RTTY_MULTS):
        exch = _RTTY_MULTS[s13 - 8001]
    else:
        raise UnsupportedMessageError(
            f"RTTY RU exchange field out of range ({s13})")
    parts = []
    if t1:
        parts.append("TU;")
    parts += [_unpack28(c28a), _unpack28(c28b)]
    if r_bit:
        parts.append("R")
    parts += [f"5{r3 + 2}9", exch]
    return " ".join(parts)


# ---------------------------------------------------------------------------
# ARRL Field Day (i3.n3 = 0.3 / 0.4): c28 c28 R1 n4 k3 S7
#
# "W9XYZ K1ABC R 16A EMA" — exchange is <transmitters><class> <section>.
# n4 holds transmitters-1 (type 0.3 covers 1..16) or transmitters-17
# (type 0.4 covers 17..32); k3 is the operating class A..F; S7 is a
# 1-based index into WSJT-X's frozen 84-entry ARRL/RAC section table.
# The table below is that list: the published ARRL + RAC section
# abbreviations of 2018 (pre PE/TER splits), in strict alphabetical
# order — the ordering is derivable, not arbitrary, which is what makes
# this type implementable offline.  Example texts from the FT8 protocol
# paper (Franke/Somerville/Taylor, QEX Jul/Aug 2020, Table 1):
# "WA9XYZ KA1ABC R 16A EMA" (0.3) and "WA9XYZ KA1ABC R 32A EMA" (0.4).

_ARRL_SECTIONS = (
    "AB AK AL AR AZ BC CO CT DE EB EMA ENY EPA EWA GA GTA IA ID IL IN "
    "KS KY LA LAX MAR MB MDC ME MI MN MO MS MT NC ND NE NFL NH NL NLI "
    "NM NNJ NNY NT NTX NV OH OK ONE ONN ONS OR ORG PAC PR QC RI SB SC "
    "SCV SD SDG SF SFL SJV SK SNJ STX SV TN TX UT VA VI VT WCF WI WMA "
    "WNY WPA WTX WV WWA WY").split()
assert len(_ARRL_SECTIONS) == 84 and _ARRL_SECTIONS == sorted(_ARRL_SECTIONS)

_FD_EXCH_RE = re.compile(r"^([1-9][0-9]?)([A-F])$")


def _try_pack_field_day(tokens: list[str]) -> int | None:
    tokens = list(tokens)
    if len(tokens) not in (4, 5):
        return None
    if len(tokens) == 5:
        if tokens[2] != "R":
            return None
        r_bit = 1
        del tokens[2:3]
    else:
        r_bit = 0
    c28a, c28b = _pack28(tokens[0]), _pack28(tokens[1])
    m = _FD_EXCH_RE.match(tokens[2])
    if c28a is None or c28b is None or m is None:
        return None
    if tokens[3] not in _ARRL_SECTIONS:
        return None
    ntx, k3 = int(m.group(1)), ord(m.group(2)) - 65
    if not 1 <= ntx <= 32:
        return None
    n3 = 3 if ntx <= 16 else 4
    n4 = ntx - 1 if ntx <= 16 else ntx - 17
    s7 = 1 + _ARRL_SECTIONS.index(tokens[3])
    f71 = c28a
    f71 = (f71 << 28) | c28b
    f71 = (f71 << 1) | r_bit
    f71 = (f71 << 4) | n4
    f71 = (f71 << 3) | k3
    f71 = (f71 << 7) | s7
    return (f71 << 6) | (n3 << 3)               # i3 = 0


def _unpack_field_day(f71: int, n3: int) -> str:
    s7 = f71 & 0x7F
    k3 = (f71 >> 7) & 7
    n4 = (f71 >> 10) & 0xF
    r_bit = (f71 >> 14) & 1
    c28b = (f71 >> 15) & ((1 << 28) - 1)
    c28a = (f71 >> 43) & ((1 << 28) - 1)
    if not 1 <= s7 <= len(_ARRL_SECTIONS) or k3 > 5:
        raise UnsupportedMessageError(
            f"Field Day section/class out of range (S7={s7}, k3={k3})")
    ntx = n4 + (1 if n3 == 3 else 17)
    parts = [_unpack28(c28a), _unpack28(c28b)]
    if r_bit:
        parts.append("R")
    parts += [f"{ntx}{chr(65 + k3)}", _ARRL_SECTIONS[s7 - 1]]
    return " ".join(parts)


# ---------------------------------------------------------------------------
# EU VHF contest (i3 = 5): h12 h22 R1 r3 s11 g25
#
# "<G4ABC> <PA9XYZ> R 570007 JO22DB" — both calls ride as hashes (12-bit
# for the first field, 22-bit for the second), the exchange is a 6-digit
# RST+serial (report 52..59 = r3+52, serial 0..2047 rendered %04d) and a
# 6-char Maidenhead locator in 25 bits.  Table-free: pure field packing,
# so it is fully verifiable by construction.  Example text from the FT8
# protocol paper (QEX Jul/Aug 2020, Table 1).

_GRID6_RE = re.compile(r"^[A-R][A-R][0-9][0-9][A-X][A-X]$")
_EU_VHF_EXCH_RE = re.compile(r"^(5[2-9])([0-9]{4})$")
_BRACKETED_RE = re.compile(r"^<([^<>]+)>$")


def _grid6_to_g25(grid: str) -> int:
    g25 = (ord(grid[0]) - 65) * 18 + (ord(grid[1]) - 65)
    g25 = g25 * 10 + int(grid[2])
    g25 = g25 * 10 + int(grid[3])
    g25 = g25 * 24 + (ord(grid[4]) - 65)
    return g25 * 24 + (ord(grid[5]) - 65)


def _g25_to_grid6(g25: int) -> str:
    c6 = g25 % 24; g25 //= 24
    c5 = g25 % 24; g25 //= 24
    d4 = g25 % 10; g25 //= 10
    d3 = g25 % 10; g25 //= 10
    c2 = g25 % 18; c1 = g25 // 18
    if c1 >= 18:
        raise UnsupportedMessageError("g25 locator out of range")
    return (chr(65 + c1) + chr(65 + c2) + str(d3) + str(d4)
            + chr(65 + c5) + chr(65 + c6))


def _hashable_call(tok: str) -> str | None:
    """A type-5 call token: "<CALL>" or a bare call; returns the inner
    call, or None when the token cannot be a callsign."""
    m = _BRACKETED_RE.match(tok)
    inner = m.group(1) if m else tok
    if inner == "..." or not 3 <= len(inner) <= 11:
        return None
    if any(c not in _B38 or c == " " for c in inner):
        return None
    if not any(c.isalpha() for c in inner) or not any(
            c.isdigit() for c in inner):
        return None
    return inner


def _try_pack_eu_vhf(tokens: list[str]) -> int | None:
    tokens = list(tokens)
    if len(tokens) not in (4, 5):
        return None
    if len(tokens) == 5:
        if tokens[2] != "R":
            return None
        r_bit = 1
        del tokens[2:3]
    else:
        r_bit = 0
    m = _EU_VHF_EXCH_RE.match(tokens[2])
    if m is None or not _GRID6_RE.match(tokens[3]):
        return None
    call1, call2 = _hashable_call(tokens[0]), _hashable_call(tokens[1])
    if call1 is None or call2 is None:
        return None
    serial = int(m.group(2))
    if serial > 2047:
        return None
    _hashes().add(call1)
    _hashes().add(call2)
    v = hash_callsign(call1, 12)
    v = (v << 22) | hash_callsign(call2, 22)
    v = (v << 1) | r_bit
    v = (v << 3) | (int(m.group(1)) - 52)
    v = (v << 11) | serial
    v = (v << 25) | _grid6_to_g25(tokens[3])
    return (v << 3) | 5


def _unpack_eu_vhf(v: int) -> str:
    g25 = (v >> 3) & ((1 << 25) - 1)
    s11 = (v >> 28) & 0x7FF
    r3 = (v >> 39) & 7
    r_bit = (v >> 42) & 1
    h22 = (v >> 43) & ((1 << 22) - 1)
    h12 = (v >> 65) & 0xFFF
    call1 = _hashes().get(h12, 12)
    call2 = _hashes().get(h22, 22)
    parts = [f"<{call1}>" if call1 else "<...>",
             f"<{call2}>" if call2 else "<...>"]
    if r_bit:
        parts.append("R")
    parts += [f"{r3 + 52}{s11:04d}", _g25_to_grid6(g25)]
    return " ".join(parts)


# ---------------------------------------------------------------------------
# public API

def pack_free_text(text: str) -> np.ndarray:
    """<=13 chars of " 0-9A-Z+-./?" -> 10-byte type-0.0 payload.

    The field is right-justified in 13 chars (WSJT-X convention), so
    round-tripping strips leading/trailing blanks.
    """
    t = text.upper().strip()
    if len(t) > 13 or any(c not in _FREETEXT for c in t):
        raise ValueError("free text is at most 13 chars of "
                         f"{_FREETEXT!r}")
    f71 = 0
    for ch in t.rjust(13):
        f71 = f71 * 42 + _FREETEXT.index(ch)
    return _int_to_payload(f71 << 6)           # n3 = 0, i3 = 0


def pack_telemetry(hex_digits: str) -> np.ndarray:
    """Up to 18 hex digits (< 2**71) -> 10-byte type-0.5 payload."""
    h = hex_digits.strip().upper()
    if not re.match(r"^[0-9A-F]{1,18}$", h):
        raise ValueError("telemetry is 1-18 hex digits")
    t71 = int(h, 16)
    if t71 >= 1 << 71:
        raise ValueError("telemetry exceeds 71 bits")
    return _int_to_payload((t71 << 6) | (5 << 3))


def pack_message(text: str,
                 hash_table: CallsignHashTable | None = None) -> np.ndarray:
    """Message text -> 10-byte payload (the TX pipeline's input).

    Tries the standard (i3=1/2) layout, then nonstandard-call (i3=4),
    then DXpedition (0.1), RTTY Roundup (i3=3), ARRL Field Day (0.3/0.4)
    and EU VHF contest (i3=5), then free text (i3.n3 = 0.0).  Telemetry
    must use pack_telemetry explicitly — short hex-looking strings like
    "73" are messages, not telemetry.

    hash_table: callsign hash cache to populate/resolve against; defaults
    to the process-global table (WSJT-X behaviour).  Pass a session-owned
    CallsignHashTable to keep bands/sessions isolated.
    """
    token = _ACTIVE_HASHES.set(hash_table) if hash_table is not None else None
    try:
        tokens = text.upper().split()
        v = _try_pack_standard(tokens)
        if v is None:
            v = _try_pack_nonstandard(tokens)
        if v is None:
            v = _try_pack_dxpedition(tokens)
        if v is None:
            v = _try_pack_rtty_ru(tokens)
        if v is None:
            v = _try_pack_field_day(tokens)
        if v is None:
            v = _try_pack_eu_vhf(tokens)
        if v is not None:
            return _int_to_payload(v)
        return pack_free_text(" ".join(tokens))
    finally:
        if token is not None:
            _ACTIVE_HASHES.reset(token)


def unpack_message(payload,
                   hash_table: CallsignHashTable | None = None) -> str:
    """10-byte payload -> message text.

    Raises UnsupportedMessageError for the reserved/unused subtypes
    (i3=0 with n3 in {2, 6, 7}; i3 in {6, 7}) so callers (e.g. the CLI)
    can fall back to payload hex.

    hash_table: see pack_message.
    """
    token = _ACTIVE_HASHES.set(hash_table) if hash_table is not None else None
    try:
        v = _payload_to_int(payload)
        i3 = v & 7
        if i3 in (1, 2):
            return _unpack_standard(v, i3)
        if i3 == 3:
            return _unpack_rtty_ru(v)
        if i3 == 4:
            return _unpack_nonstandard(v)
        if i3 == 5:
            return _unpack_eu_vhf(v)
        if i3 == 0:
            n3 = (v >> 3) & 7
            f71 = v >> 6
            if n3 == 0:
                chars = []
                for _ in range(13):
                    chars.append(_FREETEXT[f71 % 42]); f71 //= 42
                return "".join(reversed(chars)).strip()
            if n3 == 1:
                return _unpack_dxpedition(f71)
            if n3 in (3, 4):
                return _unpack_field_day(f71, n3)
            if n3 == 5:
                return f"{f71:X}"
            raise UnsupportedMessageError(
                f"message type 0.{n3} not supported")
        raise UnsupportedMessageError(f"message type i3={i3} not supported")
    finally:
        if token is not None:
            _ACTIVE_HASHES.reset(token)


def ap_hypotheses(my_call: str | None = None,
                  dx_call: str | None = None):
    """A-priori decoding hypotheses -> (values (V, 77) uint8, mask (V, 77)).

    WSJT-X-style AP decoding: during a QSO (or while monitoring) parts of
    the next message are known a priori, and clamping those payload bits
    in the LDPC decoder buys sensitivity the waveform alone cannot.
    Variants, in decreasing generality (the retry takes the FIRST variant
    that yields a CRC-valid codeword per candidate):

    - "CQ ? ?"                       (always included)
    - "MyCall ? ?"                   (my_call given)
    - "MyCall DxCall ?"              (both given)
    - "MyCall DxCall RRR/RR73/73"    (both given; exchange field fixed too)

    Every variant fixes i3 = 1 (standard message) and the fixed calls'
    suffix bits to 0.  Bit positions follow the type-1 layout
    c28a|r1a|c28b|r1b|R|g15|i3 (pack_message).
    """
    def bits_of(val, width):
        return [(val >> (width - 1 - i)) & 1 for i in range(width)]

    if dx_call is not None and my_call is None:
        raise ValueError("dx_call hypotheses need my_call too (the dx "
                         "call occupies the second field only in a "
                         "directed reply)")

    def call_c28(tok):
        c28 = _pack28(tok.strip().upper())
        if c28 is None:
            raise ValueError(f"cannot express {tok!r} in the 28-bit "
                             "callsign field (standard or <hashed> calls "
                             "only)")
        return c28

    variants: list[tuple[np.ndarray, np.ndarray]] = []

    def add(c28a=None, c28b=None, g15=None):
        v = np.zeros(77, np.uint8)
        m = np.zeros(77, bool)
        if c28a is not None:
            v[0:28] = bits_of(c28a, 28); m[0:28] = True
            m[28] = True                        # r1a = 0
        if c28b is not None:
            v[29:57] = bits_of(c28b, 28); m[29:57] = True
            m[57] = True                        # r1b = 0
        if g15 is not None:
            m[58] = True                        # R = 0
            v[59:74] = bits_of(g15, 15); m[59:74] = True
        v[76] = 1; m[74:77] = True              # i3 = 1
        variants.append((v, m))

    add(c28a=2)                                 # CQ ? ?
    if my_call is not None:
        a = call_c28(my_call)
        add(c28a=a)
        if dx_call is not None:
            b = call_c28(dx_call)
            add(c28a=a, c28b=b)
            for irpt in (2, 3, 4):              # RRR, RR73, 73
                add(c28a=a, c28b=b, g15=_MAXGRID4 + irpt)
    return (np.stack([v for v, _ in variants]),
            np.stack([m for _, m in variants]))
