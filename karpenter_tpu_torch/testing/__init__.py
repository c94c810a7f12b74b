"""Test/e2e infrastructure (reference: test/pkg/environment/common + debug),
and the port's snapshot builders and carry-over of a reference snapshot."""

from .debug import ObjectChurnWatcher  # noqa: F401
from .metrics_poller import MetricsPoller, ResourceStats, scrape_exposition  # noqa: F401
from .monitor import Monitor  # noqa: F401
