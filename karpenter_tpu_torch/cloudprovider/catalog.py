"""Programmatic KWOK instance-type catalog.

The reference embeds a 144-entry JSON (kwok/cloudprovider/instance_types.json:
3 families x 12 sizes x 2 arches x 2 OSes, 4 zones x {spot, on-demand}) built
by tools/gen_instances.go. We generate an equivalent catalog directly: same
dimensionality and label surface, our own price model (linear in CPU+memory,
30% spot discount, optional reserved tier at 45% off).
"""

from __future__ import annotations

from ..apis import labels as wk
from ..scheduling.requirements import Requirement, Requirements
from ..utils.quantity import Quantity
from .types import InstanceType, InstanceTypeOverhead, Offering

INSTANCE_SIZE_LABEL_KEY = "karpenter.kwok.sh/instance-size"
INSTANCE_FAMILY_LABEL_KEY = "karpenter.kwok.sh/instance-family"
INSTANCE_CPU_LABEL_KEY = "karpenter.kwok.sh/instance-cpu"
INSTANCE_MEMORY_LABEL_KEY = "karpenter.kwok.sh/instance-memory"

FAMILIES = {"c": 2, "s": 4, "m": 8}  # family -> GiB memory per vCPU
SIZES = [1, 2, 4, 8, 16, 32, 48, 64, 96, 128, 192, 256]
ARCHS = [wk.ARCH_AMD64, wk.ARCH_ARM64]
OSES = [wk.OS_LINUX, wk.OS_WINDOWS]
ZONES = ["test-zone-a", "test-zone-b", "test-zone-c", "test-zone-d"]

CPU_PRICE_HOURLY = 0.022  # on-demand $/vCPU/h
MEM_PRICE_HOURLY = 0.0025  # on-demand $/GiB/h
SPOT_DISCOUNT = 0.70  # spot price = 70% of on-demand
RESERVED_DISCOUNT = 0.55
ARM_DISCOUNT = 0.90  # arm is 10% cheaper


def on_demand_price(cpu: int, mem_gib: int, arch: str = wk.ARCH_AMD64) -> float:
    p = cpu * CPU_PRICE_HOURLY + mem_gib * MEM_PRICE_HOURLY
    if arch == wk.ARCH_ARM64:
        p *= ARM_DISCOUNT
    return round(p, 6)


def make_instance_type(
    family: str,
    cpu: int,
    arch: str = wk.ARCH_AMD64,
    os: str = wk.OS_LINUX,
    zones: list[str] | None = None,
    include_reserved: bool = False,
    reserved_capacity: int = 10,
) -> InstanceType:
    mem_gib = cpu * FAMILIES[family]
    name = f"{family}-{cpu}x-{arch}-{os}"
    zones = zones if zones is not None else ZONES
    base = on_demand_price(cpu, mem_gib, arch)

    offerings: list[Offering] = []
    for zone in zones:
        for ct, mult in ((wk.CAPACITY_TYPE_SPOT, SPOT_DISCOUNT), (wk.CAPACITY_TYPE_ON_DEMAND, 1.0)):
            offerings.append(
                Offering(
                    requirements=Requirements(
                        Requirement(wk.CAPACITY_TYPE_LABEL_KEY, "In", [ct]),
                        Requirement(wk.ZONE_LABEL_KEY, "In", [zone]),
                    ),
                    price=round(base * mult, 6),
                )
            )
        if include_reserved:
            offerings.append(
                Offering(
                    requirements=Requirements(
                        Requirement(wk.CAPACITY_TYPE_LABEL_KEY, "In", [wk.CAPACITY_TYPE_RESERVED]),
                        Requirement(wk.ZONE_LABEL_KEY, "In", [zone]),
                        Requirement(f"{wk.GROUP}/reservation-id", "In", [f"r-{name}-{zone}"]),
                    ),
                    price=round(base * RESERVED_DISCOUNT, 6),
                    reservation_capacity=reserved_capacity,
                )
            )

    reqs = Requirements(
        Requirement(wk.INSTANCE_TYPE_LABEL_KEY, "In", [name]),
        Requirement(wk.ARCH_LABEL_KEY, "In", [arch]),
        Requirement(wk.OS_LABEL_KEY, "In", [os]),
        Requirement(wk.ZONE_LABEL_KEY, "In", zones),
        Requirement(
            wk.CAPACITY_TYPE_LABEL_KEY,
            "In",
            [wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND] + ([wk.CAPACITY_TYPE_RESERVED] if include_reserved else []),
        ),
        Requirement(INSTANCE_SIZE_LABEL_KEY, "In", [f"{cpu}x"]),
        Requirement(INSTANCE_FAMILY_LABEL_KEY, "In", [family]),
        Requirement(INSTANCE_CPU_LABEL_KEY, "In", [str(cpu)]),
        Requirement(INSTANCE_MEMORY_LABEL_KEY, "In", [str(mem_gib * 1024)]),
    )
    return InstanceType(
        name=name,
        requirements=reqs,
        offerings=offerings,
        capacity={
            "cpu": Quantity.parse(cpu),
            "memory": Quantity.parse(f"{mem_gib}Gi"),
            "ephemeral-storage": Quantity.parse("20Gi"),
            "pods": Quantity.parse(min(16 * cpu, 1024)),
        },
        overhead=InstanceTypeOverhead(
            kube_reserved={"cpu": Quantity.parse("100m"), "memory": Quantity.parse("120Mi")},
        ),
    )


def construct_instance_types(include_reserved: bool = False) -> list[InstanceType]:
    """The full 144-type catalog (kwok/cloudprovider/helpers.go:69 equivalent)."""
    out = []
    for family in FAMILIES:
        for cpu in SIZES:
            for arch in ARCHS:
                for os in OSES:
                    out.append(make_instance_type(family, cpu, arch, os, include_reserved=include_reserved))
    return out
