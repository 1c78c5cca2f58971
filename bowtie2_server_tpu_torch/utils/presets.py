"""Preset parameter sets (ref: presets.cpp:26 PresetsV0::apply and the
policy-string engine aligner_seed_policy.cpp:356-660).

Each preset yields (Scoring, SearchPolicy kwargs). The policy string syntax
itself (SEED=..;IVAL=..) is parsed by `apply_policy_string` for --policy
compatibility.
"""
from __future__ import annotations

from .scoring import Scoring
from .simple_func import SimpleFunc

# preset -> (seed_len, n_rounds, dps, interval SimpleFunc str)
_PRESETS = {
    "very-fast":            (22, 1, 5,  "S,0,2.50"),
    "fast":                 (22, 2, 10, "S,0,2.50"),
    "sensitive":            (22, 2, 15, "S,1,1.15"),
    "very-sensitive":       (20, 3, 20, "S,1,0.50"),
    "very-fast-local":      (25, 1, 5,  "S,1,2.00"),
    "fast-local":           (22, 2, 10, "S,1,1.75"),
    "sensitive-local":      (20, 2, 15, "S,1,0.75"),
    "very-sensitive-local": (20, 3, 20, "S,1,0.50"),
}


def preset_params(name: str, local: bool):
    """Returns (scoring, policy_kwargs) for a preset name.
    Default preset: 'sensitive' (e2e) / 'sensitive-local' (ref:
    bt2_search.cpp resetOptions)."""
    if name is None:
        name = "sensitive-local" if local else "sensitive"
    if local and not name.endswith("-local"):
        name = name + "-local"
    if name not in _PRESETS:
        raise ValueError(f"unknown preset {name}")
    seed_len, rounds, dps, ival = _PRESETS[name]
    sc = Scoring.default_local() if local else Scoring.default_e2e()
    pol = dict(seed_len=seed_len, n_seed_rounds=rounds, dp_streak=dps,
               interval=SimpleFunc.parse(ival))
    return sc, pol


def apply_policy_string(policy: str, sc: Scoring, pol: dict):
    """Parse ';'-separated policy tokens (subset of the reference's tag set:
    SEED, SEEDLEN, IVAL, ROUNDS, MIN, MA, MMP, NP, RDG, RFG, NCEIL)."""
    from dataclasses import replace
    for tok in policy.split(";"):
        tok = tok.strip()
        if not tok or "=" not in tok:
            continue
        key, val = tok.split("=", 1)
        key = key.upper()
        if key == "SEEDLEN":
            pol["seed_len"] = int(val)
        elif key == "DPS":
            pol["dp_streak"] = int(val)
        elif key == "IVAL":
            pol["interval"] = SimpleFunc.parse(val)
        elif key == "ROUNDS":
            pol["n_seed_rounds"] = int(val)
        elif key == "MIN":
            sc = replace(sc, score_min=SimpleFunc.parse(val))
        elif key == "NCEIL":
            sc = replace(sc, n_ceil=SimpleFunc.parse(val))
        elif key == "MA":
            sc = replace(sc, match_bonus=int(val))
        elif key == "NP":
            sc = replace(sc, np_pen=int(val))
        elif key == "MMP":
            parts = val.lstrip("QRC").lstrip(",").split(",")
            if val[0] in "QR" and len(parts) >= 2:
                sc = replace(sc, mm_pen_max=int(parts[0]),
                             mm_pen_min=int(parts[1]))
            elif val[0] == "C":
                sc = replace(sc, mm_pen_max=int(parts[0]),
                             mm_pen_min=int(parts[0]))
        elif key == "RDG":
            c, l = (val.split(",") + ["3"])[:2]
            sc = replace(sc, rd_gap_const=int(c), rd_gap_linear=int(l))
        elif key == "RFG":
            c, l = (val.split(",") + ["3"])[:2]
            sc = replace(sc, rf_gap_const=int(c), rf_gap_linear=int(l))
    return sc, pol
