"""Runtime-env plugin base + the conda / container plugins.

Equivalent of the reference's plugin system (reference:
python/ray/_private/runtime_env/plugin.py:264 RuntimeEnvPlugin — each
plugin owns one runtime_env dict key, creates resources once per distinct
value, and mutates the worker context; conda.py / container plugins build
hermetic interpreter environments). Differences, by design:

- Registration is by importable descriptor ("module:Class") in the
  RAY_TPU_RUNTIME_ENV_PLUGINS env var (comma-separated), resolved at
  worker startup — plugins registered only in a driver's memory could
  never take effect in freshly spawned worker processes.
- `apply(value) -> restore_callable` replaces the reference's
  modify_context indirection: the plugin mutates this process directly
  and returns how to undo it (None = nothing to restore).
- The conda plugin gates on a `conda` binary; the container plugin gates
  on docker/podman. NEITHER tool ships in this build image, so both
  raise actionable errors at VALIDATION time rather than failing deep in
  a worker — the extension point itself is fully exercised by tests via
  a custom plugin.

The port's copy of ``ray_tpu/_private/runtime_env_plugin.py``.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import threading
from typing import Any, Callable, Optional

_PLUGIN_ENV_VAR = "RAY_TPU_RUNTIME_ENV_PLUGINS"


class RuntimeEnvPlugin:
    """Base: subclass, set `name` (the runtime_env key you own), and
    implement any of validate/create/apply/delete."""

    name: str = ""
    priority: int = 10  # lower applies first

    def validate(self, value: Any) -> None:
        """Raise ValueError on a malformed value. Called driver-side at
        task/actor declaration, so misconfiguration fails fast."""

    def create(self, value: Any, env_dir: str) -> None:
        """Materialize expensive resources once per distinct value (the
        framework content-hashes `value` and only calls create for a
        cache miss). `env_dir` is this value's private directory."""

    def apply(self, value: Any, env_dir: str) -> Optional[Callable[[], None]]:
        """Mutate THIS worker process for the task; return an undo
        callable (or None)."""
        return None

    def delete(self, env_dir: str) -> None:
        """Release cached resources (GC of stale runtime envs)."""
        shutil.rmtree(env_dir, ignore_errors=True)


_registry: dict[str, RuntimeEnvPlugin] = {}
# RLock: env-var plugin modules call register_plugin() while the loader
# still holds the lock (the load must be COMPLETE before the loaded flag
# becomes visible, or a concurrent validate sees an empty registry)
_registry_lock = threading.RLock()
_env_var_loaded = False


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    if not plugin.name:
        raise ValueError("plugin needs a non-empty name")
    with _registry_lock:
        _registry[plugin.name] = plugin


def _load_env_var_plugins() -> None:
    """Resolve "module:Class" descriptors from RAY_TPU_RUNTIME_ENV_PLUGINS
    (reference: RAY_RUNTIME_ENV_PLUGINS env var, plugin.py:36) — this runs
    in every process, so worker processes see the same plugin set as the
    driver that spawned them (env vars propagate through the raylet)."""
    global _env_var_loaded
    import importlib

    with _registry_lock:
        if _env_var_loaded:
            return
        for desc in filter(None,
                           os.environ.get(_PLUGIN_ENV_VAR, "").split(",")):
            mod_name, _, cls_name = desc.strip().partition(":")
            cls = getattr(importlib.import_module(mod_name), cls_name)
            register_plugin(cls())
        _env_var_loaded = True


def get_plugin(name: str) -> Optional[RuntimeEnvPlugin]:
    _load_env_var_plugins()
    with _registry_lock:
        return _registry.get(name)


def plugin_names() -> set:
    _load_env_var_plugins()
    with _registry_lock:
        return set(_registry)


def _plugin_env_dir(plugin: RuntimeEnvPlugin, value: Any) -> str:
    from ray_tpu_torch._private.runtime_env import _runtime_env_root

    key = hashlib.sha1(
        json.dumps(value, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]
    return os.path.join(_runtime_env_root(), "plugins", plugin.name, key)


def apply_plugin(name: str, value: Any) -> Optional[Callable[[], None]]:
    """create-once (content-addressed) + apply. Creation is guarded by the
    same atomic-mkdir lock + failure-breadcrumb pattern as ensure_pip_env:
    concurrent workers on one node must not run plugin.create() into the
    same env_dir, and a failed create must fail waiters fast instead of
    burning their timeout."""
    import time

    plugin = get_plugin(name)
    if plugin is None:
        return None
    env_dir = _plugin_env_dir(plugin, value)
    ready = os.path.join(env_dir, ".plugin_ready")
    failed = os.path.join(env_dir, ".plugin_failed")
    lock_dir = env_dir + ".lock"
    if not os.path.exists(ready):
        os.makedirs(env_dir, exist_ok=True)
        try:
            os.mkdir(lock_dir)  # atomic: we are the creator
            is_creator = True
        except FileExistsError:
            is_creator = False
        if is_creator:
            try:
                if os.path.exists(failed):
                    os.remove(failed)
                plugin.create(value, env_dir)
                with open(ready, "w") as f:
                    f.write("ok")
            except BaseException as e:
                with open(failed, "w") as f:
                    f.write(str(e)[:2000])
                raise
            finally:
                try:
                    os.rmdir(lock_dir)
                except OSError:
                    pass
        else:
            deadline = time.monotonic() + 600
            while not os.path.exists(ready):
                if os.path.exists(failed):
                    with open(failed) as f:
                        raise RuntimeError(
                            f"runtime_env plugin {name!r} create() failed: "
                            f"{f.read()}")
                if not os.path.isdir(lock_dir):
                    # creator vanished without ready/failed: take over
                    return apply_plugin(name, value)
                try:
                    # SIGKILLed creator (no finally ran): steal stale locks
                    # like ensure_pip_env does, keyed on mtime age
                    if time.time() - os.path.getmtime(lock_dir) > 600:
                        try:
                            os.rmdir(lock_dir)
                        except OSError:
                            pass
                        return apply_plugin(name, value)
                except OSError:
                    pass  # lock vanished between the checks: loop re-checks
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"runtime_env plugin {name!r} not ready after 600s")
                time.sleep(0.2)
    return plugin.apply(value, env_dir)


# ---------------------------------------------------------------------------
# in-tree plugins
# ---------------------------------------------------------------------------


class CondaPlugin(RuntimeEnvPlugin):
    """Hermetic conda env per spec (reference:
    _private/runtime_env/conda.py). Gated on a `conda` binary — absent in
    this build image, so validate() raises an actionable error instead of
    workers dying mid-create."""

    name = "conda"
    priority = 5  # interpreter env applies before path-level tweaks

    @staticmethod
    def _conda_bin() -> Optional[str]:
        return shutil.which("conda") or shutil.which("mamba")

    def validate(self, value: Any) -> None:
        if not isinstance(value, (str, dict)):
            raise ValueError(
                "runtime_env conda must be an env NAME (str) or an "
                "environment.yml-style dict")
        if self._conda_bin() is None:
            raise ValueError(
                "runtime_env {'conda': ...} requires a conda/mamba binary "
                "on PATH; this environment has none — use {'pip': [...]}"
                " (venv-based) instead")

    def create(self, value: Any, env_dir: str) -> None:
        conda = self._conda_bin()
        if isinstance(value, dict):
            spec_path = os.path.join(env_dir, "environment.yml")
            with open(spec_path, "w") as f:
                json.dump(value, f)  # yaml is a json superset
            subprocess.run(
                [conda, "env", "create", "-p",
                 os.path.join(env_dir, "env"), "-f", spec_path],
                check=True, capture_output=True)

    def apply(self, value: Any, env_dir: str):
        if isinstance(value, str):
            # named env: resolve its prefix from conda's env table
            out = subprocess.run(
                [self._conda_bin(), "env", "list", "--json"],
                check=True, capture_output=True, text=True)
            prefixes = json.loads(out.stdout).get("envs", [])
            match = [p for p in prefixes if os.path.basename(p) == value]
            if not match:
                raise ValueError(
                    f"conda env {value!r} not found; known envs: "
                    f"{[os.path.basename(p) for p in prefixes]}")
            env_bin = os.path.join(match[0], "bin")
        else:
            env_bin = os.path.join(env_dir, "env", "bin")
        saved = os.environ.get("PATH")
        os.environ["PATH"] = env_bin + os.pathsep + (saved or "")

        def restore():
            if saved is None:
                os.environ.pop("PATH", None)
            else:
                os.environ["PATH"] = saved

        return restore


class ContainerPlugin(RuntimeEnvPlugin):
    """Container image isolation (reference: container plugin in
    _private/runtime_env/container.py — workers launched inside an image).
    Gated on docker/podman; absent here, so validation fails fast with
    the reason."""

    name = "container"

    def validate(self, value: Any) -> None:
        if not isinstance(value, dict) or "image" not in value:
            raise ValueError(
                'runtime_env container needs {"image": "<ref>", ...}')
        if shutil.which("docker") is None and shutil.which("podman") is None:
            raise ValueError(
                "runtime_env {'container': ...} requires docker or podman "
                "on PATH; this environment has neither — container "
                "isolation is unavailable here")


register_plugin(CondaPlugin())
register_plugin(ContainerPlugin())
