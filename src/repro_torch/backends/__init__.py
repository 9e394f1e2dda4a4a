"""repro_torch.backends — the backend registry of the port."""

from repro_torch.backends.registry import (Backend, Capabilities,
                                           ExecutionPlan, capable, get,
                                           names, register, resolve,
                                           select)

__all__ = ["Backend", "Capabilities", "ExecutionPlan", "capable", "get",
           "names", "register", "resolve", "select"]
