"""The fake cloud provider's assorted instance-type generator (reference:
pkg/cloudprovider/fake/instancetype.go:369 InstanceTypesAssorted). The fake
provider itself is not ported yet.
"""

from __future__ import annotations

import itertools

from ..apis import labels as wk
from . import catalog
from .types import InstanceType


def instance_types_assorted(count: int = 400) -> list[InstanceType]:
    """A large combinatorial set for benchmarks (fake/instancetype.go:369)."""
    out = []
    combos = itertools.cycle(
        [
            (f, c, a, o)
            for f in catalog.FAMILIES
            for c in catalog.SIZES
            for a in catalog.ARCHS
            for o in catalog.OSES
        ]
    )
    seen = set()
    zone_opts = [["test-zone-a"], ["test-zone-b"], ["test-zone-a", "test-zone-b"], catalog.ZONES]
    while len(out) < count:
        f, c, a, o = next(combos)
        # mix a div-4 term in so zone variety survives the period-4 arch/os
        # cycle (a pure linear index collapses on multiples of 4)
        i = len(out)
        zones = zone_opts[(i + i // 4) % len(zone_opts)]
        key = (f, c, a, o, tuple(zones))
        it = catalog.make_instance_type(f, c, a, o, zones=zones)
        if key in seen:
            # distinct combos exhausted: emit a renamed variant
            from ..scheduling.requirements import Requirement

            it.name = f"{it.name}-v{len(out)}"
            it.requirements.replace(Requirement(wk.INSTANCE_TYPE_LABEL_KEY, "In", [it.name]))
        else:
            seen.add(key)
        out.append(it)
    return out[:count]
