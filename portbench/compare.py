"""The comparison that decides ``correct``: each answer of the window held
to the plain reference run on the same inputs.

``field_gap``: for each member and each of its five final fields,
max|program − reference| over max|reference|; the largest over the fields
and members.  The scale is each field's own size and not the scheme's
error: the exact solution does not depend on η, so the members' discrete
fields differ only where η moves the discretisation error, by ~1e-15 to
1e-13 of a field in cd and cs, a gap the scheme's error (1e-8 of a field
in cp) would hide.  A member run on another member's η reads there.
``error_gap``: where the answer carries the 3-D study's combined
max-integral error, the largest |program − reference| / reference a
member.  Each number is held to the limit the configuration file states."""

from __future__ import annotations

import torch

FIELDS = ("cp", "T", "cl", "cd", "cs")


def gaps(answer: dict, ref: dict) -> dict:
    """The compared numbers of one answer against the reference."""
    out = {}
    per_field = []
    for v in FIELDS:
        want = ref["state"][v].to(torch.float64)
        got = answer["state"][v].to(device=want.device, dtype=torch.float64)
        dims = tuple(range(1, want.dim()))
        per_field.append(torch.amax(torch.abs(got - want), dim=dims)
                         / torch.amax(torch.abs(want), dim=dims))
    out["field_gap"] = float(torch.amax(torch.stack(per_field)))  # a NaN stays NaN
    if answer.get("error") is not None and ref.get("error") is not None:
        e_ref = ref["error"].to(torch.float64).cpu()
        e_got = answer["error"].to(torch.float64).cpu()
        out["error_gap"] = float(torch.amax(torch.abs(e_got - e_ref) / e_ref))
    return out


def judge(answers, ref: dict, limits: dict):
    """(correct, failed answers, {name: (worst value, limit)}) of every
    answer, each number held to its limit; a non-finite number fails."""
    worst: dict = {}
    failed = 0
    for ans in answers:
        g = gaps(ans, ref)
        bad = False
        for name, value in g.items():
            ok = value == value and value <= limits[name]
            bad = bad or not ok
            if name not in worst or not value <= worst[name]:
                worst[name] = value
        failed += bad
    checks = {name: (worst[name], limits[name]) for name in worst}
    return bool(answers) and failed == 0, failed, checks
