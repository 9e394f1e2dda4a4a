"""Builtin backends of the port — imported lazily by the registry.

* ``ref``    — the torch row-scan oracle (slow, for validation);
* ``engine`` — the torch anti-diagonal engine;
* ``kernel`` — the CUDA wavefront (its plain version on a CPU tensor).

All three run hard-min sdtw; each adapter turns its sweep's tuple into
an :class:`~repro_torch.core.result.SDTWResult`.
"""

from __future__ import annotations

from repro_torch.backends.registry import Backend, Capabilities, register
from repro_torch.core import engine, ref
from repro_torch.core.result import from_sweep
from repro_torch.kernels import ops

_ALL = frozenset({"sqeuclidean", "abs", "cosine"})
_WINDOWED = frozenset({"cost", "end", "start"})


def _exec_ref(spec, plan):
    return from_sweep(
        ref.sdtw_ref(plan.queries, plan.reference, spec=spec,
                     return_window="start" in plan.outputs), plan.outputs)


def _exec_engine(spec, plan):
    return from_sweep(
        engine.sdtw_engine(plan.queries, plan.reference, spec=spec,
                           return_window="start" in plan.outputs),
        plan.outputs)


def _exec_kernel(spec, plan):
    return from_sweep(
        ops.sdtw_wavefront(plan.queries, plan.reference,
                           segment_width=plan.segment_width, spec=spec,
                           return_window="start" in plan.outputs),
        plan.outputs)


register(Backend(
    name="ref",
    capabilities=Capabilities(distances=_ALL, outputs=_WINDOWED),
    execute=_exec_ref))

register(Backend(
    name="engine",
    capabilities=Capabilities(distances=_ALL, outputs=_WINDOWED),
    execute=_exec_engine))

register(Backend(
    name="kernel",
    capabilities=Capabilities(
        # no cosine: the JAX kernel declines it too
        distances=frozenset(ops.wavefront.KERNEL_DISTANCES),
        outputs=_WINDOWED),
    execute=_exec_kernel))
