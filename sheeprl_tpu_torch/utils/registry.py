"""Algorithm and evaluation registries: ``@register_algorithm()`` on an
algorithm's ``main`` makes it runnable by name from the training CLI, and
``@register_evaluation(algorithms=...)`` on an ``evaluate`` function makes
checkpoints of those algorithms evaluable by the eval command (counterpart of
sheeprl_tpu/utils/registry.py)."""

from __future__ import annotations

from typing import Callable, Dict, List, Union

#: algorithm name -> {"module": dotted module, "entrypoint": function name}
algorithm_registry: Dict[str, Dict[str, str]] = {}
#: algorithm name -> {"module": dotted module, "entrypoint": function name} of its evaluation
evaluation_registry: Dict[str, Dict[str, str]] = {}


def register_algorithm(name: str = None) -> Callable:
    def decorator(fn: Callable) -> Callable:
        module = fn.__module__
        algo = name or module.split(".")[-1]
        algorithm_registry[algo] = {"module": module, "entrypoint": fn.__name__}
        return fn

    return decorator


def register_evaluation(algorithms: Union[str, List[str]]) -> Callable:
    def decorator(fn: Callable) -> Callable:
        for algo in [algorithms] if isinstance(algorithms, str) else algorithms:
            evaluation_registry[algo] = {"module": fn.__module__, "entrypoint": fn.__name__}
        return fn

    return decorator
