"""Method-latency/error metrics CloudProvider decorator.

Reference: pkg/cloudprovider/metrics/cloudprovider.go — wraps every SPI method
with a duration histogram and an errors counter labeled by method and
provider.
"""

from __future__ import annotations

import time

CLOUDPROVIDER_DURATION = "karpenter_cloudprovider_duration_seconds"
CLOUDPROVIDER_ERRORS_TOTAL = "karpenter_cloudprovider_errors_total"


def register_cloudprovider_metrics(registry) -> None:
    from ..metrics import DURATION_BUCKETS

    registry.histogram(CLOUDPROVIDER_DURATION, "CloudProvider method latency", ("method", "provider"), DURATION_BUCKETS)
    registry.counter(CLOUDPROVIDER_ERRORS_TOTAL, "CloudProvider method errors", ("method", "provider"))


class MetricsCloudProvider:
    def __init__(self, inner, registry):
        self.inner = inner
        self.registry = registry
        register_cloudprovider_metrics(registry)

    def _observe(self, method: str, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:
            self.registry.counter(CLOUDPROVIDER_ERRORS_TOTAL).inc(method=method, provider=self.inner.name())
            raise
        finally:
            self.registry.histogram(CLOUDPROVIDER_DURATION).observe(
                time.perf_counter() - t0, method=method, provider=self.inner.name()
            )

    def create(self, node_claim):
        return self._observe("Create", self.inner.create, node_claim)

    def delete(self, node_claim) -> None:
        return self._observe("Delete", self.inner.delete, node_claim)

    def get(self, provider_id: str):
        return self._observe("Get", self.inner.get, provider_id)

    def list(self) -> list:
        return self._observe("List", self.inner.list)

    def get_instance_types(self, node_pool=None) -> list:
        return self._observe("GetInstanceTypes", self.inner.get_instance_types, node_pool)

    def is_drifted(self, node_claim) -> str:
        return self._observe("IsDrifted", self.inner.is_drifted, node_claim)

    def repair_policies(self) -> list:
        return self.inner.repair_policies()

    def name(self) -> str:
        return self.inner.name()

    def get_supported_node_classes(self) -> list:
        return self.inner.get_supported_node_classes()

    def __getattr__(self, item):
        return getattr(self.inner, item)
