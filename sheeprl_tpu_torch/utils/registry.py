"""Algorithm registry: ``@register_algorithm()`` on an algorithm's ``main``
makes it runnable by name from the CLI (counterpart of
sheeprl_tpu/utils/registry.py, training entry points only)."""

from __future__ import annotations

from typing import Callable, Dict

#: algorithm name -> {"module": dotted module, "entrypoint": function name}
algorithm_registry: Dict[str, Dict[str, str]] = {}


def register_algorithm(name: str = None) -> Callable:
    def decorator(fn: Callable) -> Callable:
        module = fn.__module__
        algo = name or module.split(".")[-1]
        algorithm_registry[algo] = {"module": module, "entrypoint": fn.__name__}
        return fn

    return decorator
