"""Pods as plain arrays for the reference: `req` [P, 3] (milli-cores,
bytes, 1 pod), and per pod the index of its `my-label` value (`label`),
of its zone spread's selector value (`zone_sel`), of its hostname spread's
selector value (`host_sel`), of its `my-affinity` value (`group`), each -1
where the pod has none, and `anti` (it carries app=nginx and repels every
other such pod on its node); `keys` (namespace/name) and `uids`."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class PodArrays:
    keys: list
    uids: list
    req: np.ndarray
    label: np.ndarray
    zone_sel: np.ndarray
    host_sel: np.ndarray
    group: np.ndarray
    anti: np.ndarray
    n_values: int

    @property
    def index(self) -> dict:
        return {k: i for i, k in enumerate(self.keys)}


def arrays(specs: list[dict], values: list[str]) -> PodArrays:
    """From the benchmark's pod specs (`benchmark.inputs.burst.pod_specs`)
    and the configuration's label values."""
    P = len(specs)
    at = {v: i for i, v in enumerate(values)}
    req = np.zeros((P, 3), dtype=np.int64)
    label, zone_sel, host_sel, group = (np.full(P, -1, dtype=np.int64) for _ in range(4))
    anti = np.zeros(P, dtype=bool)
    for i, s in enumerate(specs):
        req[i] = (s["cpu_m"], s["mem_b"], 1)
        if "label" in s:
            label[i] = at[s["label"]]
        if s["kind"] == "zone_spread":
            zone_sel[i] = at[s["selects"]]
        elif s["kind"] == "hostname_spread":
            host_sel[i] = at[s["selects"]]
        elif s["kind"] == "zone_affinity":
            group[i] = at[s["group"]]
        anti[i] = s["kind"] == "hostname_anti_affinity"
    return PodArrays([s["key"] for s in specs], [s["uid"] for s in specs], req, label, zone_sel, host_sel, group,
                     anti, len(values))
