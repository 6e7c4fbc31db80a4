"""Run telemetry: the metrics registry and span recorder the driver uses."""

from spark_examples_tpu_torch.obs.metrics import MetricsRegistry
from spark_examples_tpu_torch.obs.spans import SpanRecorder

__all__ = ["MetricsRegistry", "SpanRecorder"]
