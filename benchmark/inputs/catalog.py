"""The program's `InstanceType` objects, built from the reference's plain
table (`benchmark.reference.catalog.table`), so both sides read one
catalog and a change to the program's own fake provider moves neither."""

from __future__ import annotations

from ..reference.catalog import MI, table

OSES = ["linux", "windows", "darwin"]


def instance_types(config: dict) -> list:
    from karpenter_tpu_torch.apis import labels as wk
    from karpenter_tpu_torch.cloudprovider.types import InstanceType, InstanceTypeOverhead, Offering
    from karpenter_tpu_torch.scheduling.requirements import Requirement, Requirements
    from karpenter_tpu_torch.utils.quantity import Quantity

    spec = config["catalog"]
    out = []
    for r in table(config["instance_types"], spec):
        offerings = []
        for zone in r["zones"]:
            kinds = [wk.CAPACITY_TYPE_SPOT] if zone in r["spot_zones"] else []
            for ct in kinds + [wk.CAPACITY_TYPE_ON_DEMAND]:
                offerings.append(Offering(
                    requirements=Requirements(Requirement(wk.CAPACITY_TYPE_LABEL_KEY, "In", [ct]),
                                              Requirement(wk.ZONE_LABEL_KEY, "In", [zone])),
                    price=r["price"]))
        reqs = Requirements(
            Requirement(wk.INSTANCE_TYPE_LABEL_KEY, "In", [r["name"]]),
            Requirement(wk.ARCH_LABEL_KEY, "In", [wk.ARCH_AMD64]),
            Requirement(wk.OS_LABEL_KEY, "In", OSES),
            Requirement(wk.ZONE_LABEL_KEY, "In", list(r["zones"])),
            Requirement(wk.CAPACITY_TYPE_LABEL_KEY, "In", [wk.CAPACITY_TYPE_SPOT, wk.CAPACITY_TYPE_ON_DEMAND]),
        )
        out.append(InstanceType(
            name=r["name"], requirements=reqs, offerings=offerings,
            capacity={"cpu": Quantity.parse(r["cpu"]), "memory": Quantity.parse(f"{r['mem_b'] // MI}Mi"),
                      "pods": Quantity.parse(r["pods"])},
            overhead=InstanceTypeOverhead(kube_reserved={
                "cpu": Quantity.parse(f"{spec['kube_reserved_cpu_m']}m"),
                "memory": Quantity.parse(f"{spec['kube_reserved_memory_mi']}Mi")})))
    return out
