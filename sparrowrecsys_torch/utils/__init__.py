"""Device choice, metrics, profiling and tracing."""

from sparrowrecsys_torch.utils.observability import MetricsRegistry, get_registry
from sparrowrecsys_torch.utils.profiling import StepTimer, trace
