"""Vectorised SGP4 orbit propagator (near-earth) in pure NumPy.

The reference depends on the `sgp4` package and calls it once per audio
sample — 10^6 scalar propagations for a 20 s / 50 kHz Doppler sequence
(src/ft8_tools/channel/channel.py:254-309).  This implementation follows the
standard SGP4 model (Spacetrack Report #3 as revised by Vallado et al.,
"Revisiting Spacetrack Report #3", AIAA 2006-6753) with WGS-72 constants,
and evaluates the whole time grid at once: `propagate(tle, tsince_minutes)`
takes an array of epochs-offsets in minutes and returns TEME position /
velocity arrays.

Near-earth only (orbital period < 225 min) — LEO satellite passes, which is
the reference's entire use case.  Deep-space (SDP4) TLEs raise ValueError.

A copy of ``ft8_demodulator_tpu/channel/sgp4.py`` with the same names and
behaviour, so that the port loads nothing of the JAX package
(``tests/test_torch_channel.py`` holds the two equal).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = ["TLE", "parse_tle", "Sgp4", "WGS72"]


# ---------------------------------------------------------------------------
# Gravity model (WGS-72, the standard for TLE propagation)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class GravityModel:
    mu: float                # km^3 / s^2
    radiusearthkm: float
    j2: float
    j3: float
    j4: float

    @property
    def xke(self) -> float:  # sqrt(mu) in earth-radii^1.5 per minute
        return 60.0 / math.sqrt(self.radiusearthkm ** 3 / self.mu)

    @property
    def j3oj2(self) -> float:
        return self.j3 / self.j2


WGS72 = GravityModel(
    mu=398600.8, radiusearthkm=6378.135,
    j2=0.001082616, j3=-0.00000253881215, j4=-0.00000165597,
)

_TWOPI = 2.0 * math.pi
_DEG2RAD = math.pi / 180.0
_MIN_PER_DAY = 1440.0


# ---------------------------------------------------------------------------
# TLE parsing
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TLE:
    """Parsed two-line element set (angles in radians, n in rad/min)."""

    satnum: str
    epoch_jd: float          # Julian date of epoch (UT)
    ndot: float              # rad/min^2 (not used by SGP4 proper)
    nddot: float             # rad/min^3
    bstar: float             # 1/earth-radii
    inclo: float             # inclination
    nodeo: float             # RAAN
    ecco: float              # eccentricity
    argpo: float             # argument of perigee
    mo: float                # mean anomaly
    no_kozai: float          # mean motion, rad/min
    line1: str = ""
    line2: str = ""


def _tle_float(fld: str) -> float:
    """Parse TLE's packed exponent notation, e.g. ' 39580-3' -> 0.39580e-3."""
    fld = fld.strip()
    if not fld:
        return 0.0
    if fld[0] in "+-":
        sign, fld = (-1.0 if fld[0] == "-" else 1.0), fld[1:]
    else:
        sign = 1.0
    mant, exp = fld[:-2], fld[-2:]
    return sign * float("0." + mant.strip()) * 10.0 ** int(exp)


def _epoch_to_jd(epoch_year: int, epoch_days: float) -> float:
    year = epoch_year + 2000 if epoch_year < 57 else epoch_year + 1900
    # JD of Jan 0.0 of `year`
    jd0 = julian_date(year, 1, 1, 0, 0, 0.0) - 1.0
    return jd0 + epoch_days


def julian_date(year: int, month: int, day: int, hour: int = 0,
                minute: int = 0, second: float = 0.0) -> float:
    """Standard Gregorian-calendar Julian date (Vallado algorithm 14)."""
    jd = (367.0 * year
          - math.floor(7.0 * (year + math.floor((month + 9.0) / 12.0)) * 0.25)
          + math.floor(275.0 * month / 9.0)
          + day + 1721013.5)
    return jd + ((second / 60.0 + minute) / 60.0 + hour) / 24.0


def parse_tle(line1: str, line2: str) -> TLE:
    if not line1.startswith("1 ") or not line2.startswith("2 "):
        raise ValueError("malformed TLE")
    epoch_year = int(line1[18:20])
    epoch_days = float(line1[20:32])
    ndot = float(line1[33:43]) * _TWOPI / (_MIN_PER_DAY ** 2)
    nddot = _tle_float(line1[44:52]) * _TWOPI / (_MIN_PER_DAY ** 3)
    bstar = _tle_float(line1[53:61])
    inclo = float(line2[8:16]) * _DEG2RAD
    nodeo = float(line2[17:25]) * _DEG2RAD
    ecco = float("0." + line2[26:33].strip())
    argpo = float(line2[34:42]) * _DEG2RAD
    mo = float(line2[43:51]) * _DEG2RAD
    no_kozai = float(line2[52:63]) * _TWOPI / _MIN_PER_DAY
    return TLE(
        satnum=line1[2:7].strip(), epoch_jd=_epoch_to_jd(epoch_year, epoch_days),
        ndot=ndot, nddot=nddot, bstar=bstar, inclo=inclo, nodeo=nodeo,
        ecco=ecco, argpo=argpo, mo=mo, no_kozai=no_kozai,
        line1=line1, line2=line2,
    )


# ---------------------------------------------------------------------------
# SGP4 initialisation + propagation
# ---------------------------------------------------------------------------

class Sgp4:
    """Near-earth SGP4 propagator; `propagate` is vectorised over time."""

    def __init__(self, tle: TLE, gravity: GravityModel = WGS72):
        self.tle = tle
        self.g = gravity
        self._init()

    # -- initialisation (scalar, once) --------------------------------------
    def _init(self) -> None:
        g = self.g
        t = self.tle
        xke = g.xke
        j2, j4, j3oj2 = g.j2, g.j4, g.j3oj2

        ecco, inclo, no_kozai = t.ecco, t.inclo, t.no_kozai

        eccsq = ecco * ecco
        omeosq = 1.0 - eccsq
        rteosq = math.sqrt(omeosq)
        cosio = math.cos(inclo)
        cosio2 = cosio * cosio

        # un-Kozai the mean motion
        ak = (xke / no_kozai) ** (2.0 / 3.0)
        d1 = 0.75 * j2 * (3.0 * cosio2 - 1.0) / (rteosq * omeosq)
        del_ = d1 / (ak * ak)
        adel = ak * (1.0 - del_ * del_ - del_ *
                     (1.0 / 3.0 + 134.0 * del_ * del_ / 81.0))
        del_ = d1 / (adel * adel)
        no_unkozai = no_kozai / (1.0 + del_)
        if _TWOPI / no_unkozai >= 225.0:
            raise ValueError("deep-space TLE: SDP4 not supported")

        ao = (xke / no_unkozai) ** (2.0 / 3.0)
        sinio = math.sin(inclo)
        po = ao * omeosq
        con42 = 1.0 - 5.0 * cosio2
        con41 = -con42 - cosio2 - cosio2
        posq = po * po
        rp = ao * (1.0 - ecco)

        self.isimp = rp < (220.0 / g.radiusearthkm + 1.0)

        sfour = 78.0 / g.radiusearthkm + 1.0
        qzms24 = ((120.0 - 78.0) / g.radiusearthkm) ** 4
        perige = (rp - 1.0) * g.radiusearthkm
        if perige < 156.0:
            sfour = perige - 78.0
            if perige < 98.0:
                sfour = 20.0
            qzms24 = ((120.0 - sfour) / g.radiusearthkm) ** 4
            sfour = sfour / g.radiusearthkm + 1.0

        pinvsq = 1.0 / posq
        tsi = 1.0 / (ao - sfour)
        self.eta = ao * ecco * tsi
        etasq = self.eta * self.eta
        eeta = ecco * self.eta
        psisq = abs(1.0 - etasq)
        coef = qzms24 * tsi ** 4
        coef1 = coef / psisq ** 3.5
        cc2 = coef1 * no_unkozai * (
            ao * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
            + 0.375 * j2 * tsi / psisq * con41
            * (8.0 + 3.0 * etasq * (8.0 + etasq)))
        self.cc1 = t.bstar * cc2
        cc3 = 0.0
        if ecco > 1.0e-4:
            cc3 = -2.0 * coef * tsi * j3oj2 * no_unkozai * sinio / ecco
        self.omgcof = t.bstar * cc3 * math.cos(t.argpo)
        self.x1mth2 = 1.0 - cosio2
        self.cc4 = (2.0 * no_unkozai * coef1 * ao * omeosq *
                    (self.eta * (2.0 + 0.5 * etasq)
                     + ecco * (0.5 + 2.0 * etasq)
                     - j2 * tsi / (ao * psisq)
                     * (-3.0 * con41 * (1.0 - 2.0 * eeta + etasq
                                        * (1.5 - 0.5 * eeta))
                        + 0.75 * self.x1mth2
                        * (2.0 * etasq - eeta * (1.0 + etasq))
                        * math.cos(2.0 * t.argpo))))
        self.cc5 = (2.0 * coef1 * ao * omeosq *
                    (1.0 + 2.75 * (etasq + eeta) + eeta * etasq))

        cosio4 = cosio2 * cosio2
        temp1 = 1.5 * j2 * pinvsq * no_unkozai
        temp2 = 0.5 * temp1 * j2 * pinvsq
        temp3 = -0.46875 * j4 * pinvsq * pinvsq * no_unkozai
        self.mdot = (no_unkozai + 0.5 * temp1 * rteosq * con41
                     + 0.0625 * temp2 * rteosq
                     * (13.0 - 78.0 * cosio2 + 137.0 * cosio4))
        self.argpdot = (-0.5 * temp1 * con42
                        + 0.0625 * temp2
                        * (7.0 - 114.0 * cosio2 + 395.0 * cosio4)
                        + temp3 * (3.0 - 36.0 * cosio2 + 49.0 * cosio4))
        xhdot1 = -temp1 * cosio
        self.nodedot = (xhdot1 + (0.5 * temp2 * (4.0 - 19.0 * cosio2)
                                  + 2.0 * temp3 * (3.0 - 7.0 * cosio2))
                        * cosio)
        self.xmcof = 0.0
        if ecco > 1.0e-4:
            self.xmcof = -(2.0 / 3.0) * coef * t.bstar / eeta
        self.nodecf = 3.5 * omeosq * xhdot1 * self.cc1
        self.t2cof = 1.5 * self.cc1
        # avoid divide by zero for ecco near 1
        if abs(1.0 + cosio) > 1.5e-12:
            self.xlcof = (-0.25 * j3oj2 * sinio
                          * (3.0 + 5.0 * cosio) / (1.0 + cosio))
        else:
            self.xlcof = (-0.25 * j3oj2 * sinio
                          * (3.0 + 5.0 * cosio) / 1.5e-12)
        self.aycof = -0.5 * j3oj2 * sinio
        self.delmo = (1.0 + self.eta * math.cos(t.mo)) ** 3
        self.sinmao = math.sin(t.mo)
        self.x7thm1 = 7.0 * cosio2 - 1.0

        if not self.isimp:
            cc1sq = self.cc1 * self.cc1
            self.d2 = 4.0 * ao * tsi * cc1sq
            temp = self.d2 * tsi * self.cc1 / 3.0
            self.d3 = (17.0 * ao + sfour) * temp
            self.d4 = (0.5 * temp * ao * tsi
                       * (221.0 * ao + 31.0 * sfour) * self.cc1)
            self.t3cof = self.d2 + 2.0 * cc1sq
            self.t4cof = 0.25 * (3.0 * self.d3 + self.cc1
                                 * (12.0 * self.d2 + 10.0 * cc1sq))
            self.t5cof = 0.2 * (3.0 * self.d4 + 12.0 * self.cc1 * self.d3
                                + 6.0 * self.d2 * self.d2
                                + 15.0 * cc1sq * (2.0 * self.d2 + cc1sq))
        else:
            self.d2 = self.d3 = self.d4 = 0.0
            self.t3cof = self.t4cof = self.t5cof = 0.0

        self.no_unkozai = no_unkozai
        self.ao = ao
        self.omeosq = omeosq
        self.con41 = con41
        self.cosio = cosio
        self.sinio = sinio
        self.argpo = t.argpo
        self.mo = t.mo
        self.nodeo = t.nodeo
        self.ecco = ecco
        self.bstar = t.bstar

    # -- propagation (vectorised over tsince) --------------------------------
    def propagate(self, tsince_min) -> tuple[np.ndarray, np.ndarray]:
        """tsince (minutes past epoch, array) -> (r_teme km, v_teme km/s).

        Output shapes: (..., 3).
        """
        g = self.g
        xke = g.xke
        j2 = g.j2
        t = np.asarray(tsince_min, dtype=np.float64)

        # secular gravity + atmospheric drag
        xmdf = self.mo + self.mdot * t
        argpdf = self.argpo + self.argpdot * t
        nodedf = self.nodeo + self.nodedot * t
        argpm = argpdf
        mm = xmdf
        t2 = t * t
        nodem = nodedf + self.nodecf * t2
        tempa = 1.0 - self.cc1 * t
        tempe = self.bstar * self.cc4 * t
        templ = self.t2cof * t2

        if not self.isimp:
            delomg = self.omgcof * t
            delmtemp = 1.0 + self.eta * np.cos(xmdf)
            delm = self.xmcof * (delmtemp ** 3 - self.delmo)
            temp = delomg + delm
            mm = xmdf + temp
            argpm = argpdf - temp
            t3 = t2 * t
            t4 = t3 * t
            tempa = tempa - self.d2 * t2 - self.d3 * t3 - self.d4 * t4
            tempe = tempe + self.bstar * self.cc5 * (np.sin(mm) - self.sinmao)
            templ = templ + self.t3cof * t3 + t4 * (self.t4cof
                                                    + t * self.t5cof)

        n = self.no_unkozai
        am = (xke / n) ** (2.0 / 3.0) * tempa * tempa
        n = xke / am ** 1.5
        em = self.ecco - tempe
        em = np.clip(em, 1.0e-6, 0.999999)
        mm = mm + self.no_unkozai * templ
        xlm = mm + argpm + nodem
        nodem = np.mod(nodem, _TWOPI)
        argpm = np.mod(argpm, _TWOPI)
        xlm = np.mod(xlm, _TWOPI)
        mm = np.mod(xlm - argpm - nodem, _TWOPI)

        # long-period periodics
        sinim = self.sinio
        cosim = self.cosio
        axnl = em * np.cos(argpm)
        temp = 1.0 / (am * (1.0 - em * em))
        aynl = em * np.sin(argpm) + temp * self.aycof
        xl = mm + argpm + nodem + temp * self.xlcof * axnl

        # Kepler's equation for (E + argp)
        u = np.mod(xl - nodem, _TWOPI)
        eo1 = u.copy()
        for _ in range(10):
            sineo1 = np.sin(eo1)
            coseo1 = np.cos(eo1)
            tem5 = ((u - aynl * coseo1 + axnl * sineo1 - eo1)
                    / (1.0 - coseo1 * axnl - sineo1 * aynl))
            tem5 = np.clip(tem5, -0.95, 0.95)
            eo1 = eo1 + tem5
            if np.all(np.abs(tem5) < 1.0e-12):
                break

        # short-period periodics
        ecose = axnl * coseo1 + aynl * sineo1
        esine = axnl * sineo1 - aynl * coseo1
        el2 = axnl * axnl + aynl * aynl
        pl = am * (1.0 - el2)
        rl = am * (1.0 - ecose)
        rdotl = np.sqrt(am) * esine / rl
        rvdotl = np.sqrt(pl) / rl
        betal = np.sqrt(1.0 - el2)
        temp = esine / (1.0 + betal)
        sinu = am / rl * (sineo1 - aynl - axnl * temp)
        cosu = am / rl * (coseo1 - axnl + aynl * temp)
        su = np.arctan2(sinu, cosu)
        sin2u = (cosu + cosu) * sinu
        cos2u = 1.0 - 2.0 * sinu * sinu
        temp = 1.0 / pl
        temp1 = 0.5 * j2 * temp
        temp2 = temp1 * temp

        mrt = (rl * (1.0 - 1.5 * temp2 * betal * self.con41)
               + 0.5 * temp1 * self.x1mth2 * cos2u)
        su = su - 0.25 * temp2 * self.x7thm1 * sin2u
        xnode = nodem + 1.5 * temp2 * cosim * sin2u
        xinc = self.tle.inclo + 1.5 * temp2 * cosim * sinim * cos2u
        mvt = rdotl - n * temp1 * self.x1mth2 * sin2u / xke
        rvdot = (rvdotl + n * temp1
                 * (self.x1mth2 * cos2u + 1.5 * self.con41) / xke)

        # orientation vectors -> TEME position/velocity
        sinsu = np.sin(su)
        cossu = np.cos(su)
        snod = np.sin(xnode)
        cnod = np.cos(xnode)
        sini = np.sin(xinc)
        cosi = np.cos(xinc)
        xmx = -snod * cosi
        xmy = cnod * cosi
        ux = xmx * sinsu + cnod * cossu
        uy = xmy * sinsu + snod * cossu
        uz = sini * sinsu
        vx = xmx * cossu - cnod * sinsu
        vy = xmy * cossu - snod * sinsu
        vz = sini * cossu

        er = g.radiusearthkm
        vkmps = er * xke / 60.0
        r = np.stack([mrt * ux, mrt * uy, mrt * uz], axis=-1) * er
        v = np.stack([mvt * ux + rvdot * vx,
                      mvt * uy + rvdot * vy,
                      mvt * uz + rvdot * vz], axis=-1) * vkmps
        return r, v
