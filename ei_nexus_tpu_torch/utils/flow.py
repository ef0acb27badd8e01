"""Named-tensor dataflow graph ("Flow"): declare transitions between named
values and lazily evaluate the requested outputs.

A copy of `ei_nexus_tpu/utils/flow.py` (pure Python), the surface of SiLK's
`Flow` engine (define_transition, get_tape, AutoForward): a model declares
derived outputs by name and a caller requests exactly the set it needs;
only the needed sub-graph runs. Evaluation is composed Python calls over
whatever values the transitions take (tensors here).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence, Tuple


class Flow:
    """A DAG of named transitions.

    >>> flow = Flow("x")
    >>> flow.define_transition("y", lambda x: x * 2, "x")
    >>> flow.define_transition("z", lambda x, y: x + y, "x", "y")
    >>> flow("z", x=3)          # -> 9
    >>> flow(("y", "z"), x=3)   # -> (6, 9)
    """

    def __init__(self, *inputs: str):
        self._inputs: Tuple[str, ...] = tuple(inputs)
        self._transitions: Dict[str, Tuple[Callable, Tuple[str, ...]]] = {}

    @property
    def names(self) -> Tuple[str, ...]:
        return self._inputs + tuple(self._transitions)

    def define_transition(self, name: str, fn: Callable,
                          *deps: str) -> None:
        if name in self._inputs or name in self._transitions:
            raise ValueError(f"flow name {name!r} already defined")
        self._transitions[name] = (fn, tuple(deps))

    def get_tape(self, outputs: Sequence[str]) -> List[str]:
        """Topologically ordered transition names needed for `outputs`."""
        tape: List[str] = []
        visiting: set = set()
        done: set = set(self._inputs)

        def visit(name: str):
            if name in done:
                return
            if name in visiting:
                raise ValueError(f"cycle through {name!r}")
            if name not in self._transitions:
                raise KeyError(f"unknown flow value {name!r}")
            visiting.add(name)
            _, deps = self._transitions[name]
            for d in deps:
                visit(d)
            visiting.discard(name)
            done.add(name)
            tape.append(name)

        for out in outputs:
            visit(out)
        return tape

    def __call__(self, outputs, **inputs: Any):
        """Evaluate the named output (str) or tuple of outputs."""
        single = isinstance(outputs, str)
        wanted = (outputs,) if single else tuple(outputs)
        missing = set(self._inputs) - set(inputs)
        if missing:
            raise ValueError(f"missing flow inputs {sorted(missing)}")
        values: Dict[str, Any] = dict(inputs)
        for name in self.get_tape(wanted):
            fn, deps = self._transitions[name]
            values[name] = fn(*(values[d] for d in deps))
        result = tuple(values[w] for w in wanted)
        return result[0] if single else result


class AutoForward:
    """Mixin binding a Flow and a default output set (reference
    AutoForward, silk/flow.py:295): `forward_flow` evaluates requested (or
    default) outputs against the instance's flow."""

    def __init__(self, flow: Flow, default_outputs):
        self._flow = flow
        self._default_outputs = default_outputs

    @property
    def flow(self) -> Flow:
        return self._flow

    def forward_flow(self, outputs=None, **inputs):
        return self._flow(outputs if outputs is not None
                          else self._default_outputs, **inputs)
