"""GPRMC sentence parsing (include/mrg_slam/nmea_sentence_parser.hpp).

Counterpart of the JAX package's utils/nmea.py, the same plain Python:
checksum validation and degrees-minutes to decimal degrees.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class GPRMC:
    valid: bool
    latitude: float
    longitude: float


def checksum_ok(sentence: str) -> bool:
    s = sentence.strip()
    if not s.startswith("$") or "*" not in s:
        return False
    body, _, chk = s[1:].partition("*")
    acc = 0
    for ch in body:
        acc ^= ord(ch)
    try:
        return acc == int(chk[:2], 16)
    except ValueError:
        return False


def degmin_to_deg(value: str, hemi: str) -> float:
    v = float(value)
    deg = int(v / 100)
    minutes = v - deg * 100
    out = deg + minutes / 60.0
    if hemi in ("S", "W"):
        out = -out
    return out


def parse_gprmc(sentence: str) -> Optional[GPRMC]:
    if not checksum_ok(sentence):
        return None
    fields = sentence.strip().split("*")[0].split(",")
    if not fields[0].endswith("RMC") or len(fields) < 7:
        return None
    status = fields[2]
    if status != "A":
        return GPRMC(valid=False, latitude=0.0, longitude=0.0)
    lat = degmin_to_deg(fields[3], fields[4])
    lon = degmin_to_deg(fields[5], fields[6])
    return GPRMC(valid=True, latitude=lat, longitude=lon)
