"""serve substrate: the batched engine plus the checkpoint-as-deployment
control plane (catalog subscriber → chunk-delta pull → rolling atomic
weight swap)."""
from repro_torch.serve.engine import (
    ServeState,
    ServingEngine,
    WeightsHandle,
    make_serve_step,
)

__all__ = ["ServeState", "ServingEngine", "WeightsHandle",
           "make_serve_step"]
