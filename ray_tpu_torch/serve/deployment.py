"""@deployment decorator, Deployment, and Application (bind graph): the
port's copy of ``ray_tpu/serve/deployment.py``; ``build_spec`` serializes
the callable and its bind arguments with the port's by-value pickler
(``_private/task_spec.py``), so a class defined in ``__main__`` or in a
test crosses to the replica, and the controller reads neither.

Equivalent of the reference's deployment API
(reference: python/ray/serve/api.py:265 @serve.deployment;
serve/deployment.py Deployment.bind; graph build
serve/_private/deployment_graph_build.py). Bind arguments that are
Applications become DeploymentHandles at replica init (model composition).
"""
from __future__ import annotations

from typing import Any, Callable

from ray_tpu_torch._private import task_spec as ts
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig


class Deployment:
    def __init__(self, func_or_class: Callable, name: str, config: DeploymentConfig):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config

    def options(self, **opts) -> "Deployment":
        import dataclasses

        cfg_fields = {f.name for f in dataclasses.fields(DeploymentConfig)}
        cfg_updates = {k: v for k, v in opts.items() if k in cfg_fields}
        cfg = dataclasses.replace(self.config, **cfg_updates)
        if "autoscaling_config" in opts and isinstance(opts["autoscaling_config"], dict):
            cfg.autoscaling_config = AutoscalingConfig(**opts["autoscaling_config"])
        name = opts.get("name", self.name)
        return Deployment(self.func_or_class, name, cfg)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)

    def __call__(self, *a, **k):
        raise TypeError(
            f"deployment {self.name} cannot be called directly; deploy it with "
            "serve.run() and call the returned handle"
        )


class Application:
    """A bound deployment (+ its transitively bound children)."""

    def __init__(self, deployment: Deployment, args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs

    def flatten(self) -> list["Application"]:
        """Self + all child Applications appearing in bind args."""
        out = [self]
        seen = {id(self)}

        def visit(v):
            if isinstance(v, Application):
                if id(v) not in seen:
                    seen.add(id(v))
                    out.append(v)
                    for a in list(v.args) + list(v.kwargs.values()):
                        visit(a)
            elif isinstance(v, (list, tuple)):
                for x in v:
                    visit(x)
            elif isinstance(v, dict):
                for x in v.values():
                    visit(x)

        for a in list(self.args) + list(self.kwargs.values()):
            visit(a)
        return out

    def build_spec(self, app_name: str) -> dict:
        """Controller-side deployment spec for THIS node of the graph."""
        from ray_tpu_torch.serve.replica import HandleArg

        def swap(v):
            if isinstance(v, Application):
                return HandleArg(v.deployment.name, app_name)
            if isinstance(v, (list, tuple)):
                return type(v)(swap(x) for x in v)
            if isinstance(v, dict):
                return {k: swap(x) for k, x in v.items()}
            return v

        args = tuple(swap(a) for a in self.args)
        kwargs = {k: swap(v) for k, v in self.kwargs.items()}
        return {
            "name": self.deployment.name,
            "callable_blob": ts.dumps_function(self.deployment.func_or_class),
            # the constructor's arguments as bytes as well: the controller
            # hands them to each replica unread, so an argument whose
            # class loads torch (an EngineConfig, weights) loads none in
            # the controller's process
            "init_blob": ts.dumps_function((args, kwargs)),
            "config": self.deployment.config,
        }


def deployment(
    _func_or_class: Callable | None = None,
    *,
    name: str | None = None,
    num_replicas: int | None = None,
    max_ongoing_requests: int = 8,
    autoscaling_config: dict | AutoscalingConfig | None = None,
    ray_actor_options: dict | None = None,
    health_check_period_s: float = 1.0,
    user_config: dict | None = None,
):
    """Convert a class or function into a servable Deployment
    (reference: serve/api.py:265)."""

    if isinstance(autoscaling_config, dict):
        autoscaling_config = AutoscalingConfig(**autoscaling_config)

    def wrap(func_or_class):
        cfg = DeploymentConfig(
            num_replicas=num_replicas or 1,
            max_ongoing_requests=max_ongoing_requests,
            autoscaling_config=autoscaling_config,
            ray_actor_options=dict(ray_actor_options or {}),
            health_check_period_s=health_check_period_s,
            user_config=user_config,
        )
        return Deployment(func_or_class, name or func_or_class.__name__, cfg)

    return wrap if _func_or_class is None else wrap(_func_or_class)
