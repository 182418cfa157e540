"""Name → class registries.

Parity with the reference registries
(`runway_for_ml/utils/global_variables.py:1-31`): executors, transform
functors, and models register by decorator and are looked up by name from
configs.
"""

from __future__ import annotations

Executor_Registry = {}
DataTransform_Registry = {}
Model_Registry = {}


def _register(registry):
    def deco(cls):
        registry[cls.__name__] = cls
        return cls

    return deco


register_executor = _register(Executor_Registry)
register_transform_functor = _register(DataTransform_Registry)
register_model = _register(Model_Registry)
