"""Host-port conflict tracking (reference: pkg/scheduling/hostportusage.go).

Two pods conflict on a node if they request the same (ip, port, protocol),
with 0.0.0.0 wildcarding the ip dimension.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class HostPort:
    ip: str
    port: int
    protocol: str = "TCP"

    def matches(self, other: "HostPort") -> bool:
        if self.protocol != other.protocol or self.port != other.port:
            return False
        return self.ip == other.ip or self.ip == "0.0.0.0" or other.ip == "0.0.0.0"


def pod_host_ports(pod) -> list[HostPort]:
    out = []
    for c in list(pod.spec.containers) + list(pod.spec.init_containers):
        for p in c.ports:
            if p.get("hostPort"):
                ip = p.get("hostIP") or "0.0.0.0"
                out.append(HostPort(ip=ip, port=int(p["hostPort"]), protocol=p.get("protocol", "TCP")))
    return out


class HostPortUsage:
    """Tracks host-port usage per node; Conflicts() validates a candidate pod."""

    def __init__(self):
        self._reserved: dict[str, list[HostPort]] = {}  # pod key -> ports

    def conflicts(self, pod_key: str, ports: list[HostPort]) -> str | None:
        for key, used in self._reserved.items():
            if key == pod_key:
                continue
            for u in used:
                for p in ports:
                    if u.matches(p):
                        return f"host port {p.port}/{p.protocol} conflicts with existing pod {key}"
        return None

    def add(self, pod_key: str, ports: list[HostPort]) -> None:
        if ports:
            self._reserved[pod_key] = ports

    def remove(self, pod_key: str) -> None:
        self._reserved.pop(pod_key, None)

    def all_ports(self) -> list[HostPort]:
        """Every reserved port across pods (the node's current usage)."""
        return [p for ports in self._reserved.values() for p in ports]

    def copy(self) -> "HostPortUsage":
        c = HostPortUsage()
        c._reserved = {k: list(v) for k, v in self._reserved.items()}
        return c
