"""MIRTK ``par/*.cfg`` parameter-file compatibility parser.

The reference drives every registration through MIRTK parameter files
(``par/ffd_cine_2d_motion.cfg:5-12`` — 3 levels,
``SSD(I1, I2 o T) + 1e-1 BE``, control spacing 10, padding -1;
``par/ffd_aortic_motion.cfg:5-12`` — 1 level, ``NMI(...) + 1e-4BE``).
A user migrating with their own tuned ``.cfg`` should not have to
hand-translate: :func:`load_par_cfg` reads the MIRTK key-value format
and returns the equivalent :class:`~ukbb_cardiac_tpu_torch.reg.register.RegConfig`
(the port's copy of ``ukbb_cardiac_tpu/reg/parcfg.py``).

Only the keys that parameterise this framework's registration are
mapped; MIRTK optimiser-internals (step-length streaks, epsilon) have
no counterpart here — the Adam schedule replaces that line-search — and
are accepted but ignored (reported in the returned ``ignored`` list so
nothing is dropped silently).
"""

from __future__ import annotations

import re
from typing import List, Tuple

from ukbb_cardiac_tpu_torch.reg.register import RegConfig

# "SSD(I1, I2 o T) + 1e-1 BE"  /  "NMI(I1, I2 o T) + 1e-4BE"
_ENERGY_RE = re.compile(
    r"(?P<metric>SSD|NMI)\s*\([^)]*\)"
    r"(?:\s*\+\s*(?P<be>[0-9.eE+-]+)\s*BE)?",
    re.IGNORECASE)


def parse_energy(expr: str) -> Tuple[str, float]:
    """Parse a MIRTK energy-function expression into (metric, be_weight)."""
    m = _ENERGY_RE.search(expr)
    if not m:
        raise ValueError(f"unrecognised MIRTK energy function: {expr!r}")
    metric = m.group("metric").lower()
    be = float(m.group("be")) if m.group("be") is not None else 0.0
    return metric, be


def load_par_cfg(path: str, base: RegConfig | None = None
                 ) -> Tuple[RegConfig, List[str]]:
    """Read a MIRTK parameter file into a :class:`RegConfig`.

    Returns ``(config, ignored)`` where ``ignored`` lists the keys that
    have no equivalent in this registration (optimiser line-search
    internals, per-level blur/resolution overrides left at MIRTK
    defaults).  Unknown keys raise — a tuned parameter must not be
    dropped without the user noticing.
    """
    import dataclasses

    fields = {}
    ignored: List[str] = []
    in_level_section = False
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" not in line:
                raise ValueError(f"{path}: unparseable line {raw!r}")
            key, val = (s.strip() for s in line.split("=", 1))
            lkey = key.lower()
            if lkey == "resolution level":
                in_level_section = True
                ignored.append(f"{key} = {val}")
                continue
            if lkey == "no. of resolution levels":
                fields["levels"] = int(val)
            elif lkey == "energy function":
                metric, be = parse_energy(val)
                fields["metric"] = metric
                fields["be_weight"] = be
            elif lkey == "control point spacing":
                fields["spacing"] = int(float(val))
            elif lkey == "padding value":
                fields["padding_value"] = float(val)
            elif lkey == "transformation model":
                if val.upper() != "FFD":
                    raise ValueError(
                        f"{path}: only FFD transformations are supported "
                        f"(got {val!r})")
            elif lkey in ("multi-level transformation", "epsilon",
                          "maximum streak of rejected steps",
                          "maximum length of steps",
                          "minimum length of steps",
                          "blurring", "resolution of image 1",
                          "resolution of image 2"):
                # optimiser internals / per-level pyramid overrides: the
                # Adam schedule and the RegConfig smooth_sigma pyramid
                # replace MIRTK's gradient-descent line search
                ignored.append(f"{key} = {val}")
            else:
                if in_level_section:
                    # be permissive inside per-level sections: MIRTK
                    # accepts many level-local keys, all of which map to
                    # the fixed pyramid here
                    ignored.append(f"{key} = {val}")
                else:
                    raise ValueError(
                        f"{path}: unknown MIRTK parameter {key!r} — "
                        "translate it to RegConfig explicitly")
    cfg = base if base is not None else RegConfig()
    # NMI default operating point uses more iterations (RegConfig.
    # aortic_motion); keep whatever iters/lr the base carries.
    cfg = dataclasses.replace(cfg, **fields)
    return cfg, ignored
