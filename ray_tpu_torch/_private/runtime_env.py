"""Runtime environments: per-task/actor env application (the port's copy
of ``ray_tpu/_private/runtime_env.py``).

Equivalent of the reference's runtime_env subsystem (reference:
python/ray/runtime_env/ + python/ray/_private/runtime_env/ — plugin base
plugin.py:264, pip plugin pip.py; design doc
python/ray/runtime_env/ARCHITECTURE.md).

Supported fields:
  * env_vars: {name: value} — set for the task's duration (actor lifetime
    for actor-creation tasks, since the process is dedicated).
  * working_dir: local directory — cwd for the task's duration. Local path
    only (the reference ships zips through its GCS package store).
  * py_modules: list of local dirs prepended to sys.path.
  * pip: list of requirement specs, or {"packages": [...],
    "pip_install_options": [...]} — materialized ONCE per unique spec as a
    content-addressed venv under RAY_TPU_RUNTIME_ENV_DIR
    (~/.ray_tpu/runtime_envs by default) whose site-packages is injected
    onto sys.path for the task. Deviation from the reference (pip.py swaps
    the worker's interpreter for the venv python): injection keeps the
    already-warm worker process — and its loaded torch and CUDA context —
    alive, which matters where backend re-init costs seconds.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import subprocess
import sys
import time

_KNOWN = {"env_vars", "working_dir", "py_modules", "pip"}


def validate_runtime_env(env: dict | None) -> None:
    if not env:
        return
    from ray_tpu_torch._private import runtime_env_plugin as rep

    unknown = set(env) - _KNOWN - rep.plugin_names()
    if unknown:
        raise ValueError(
            f"unsupported runtime_env fields {sorted(unknown)}; supported: "
            f"{sorted(_KNOWN | rep.plugin_names())}"
        )
    wd = env.get("working_dir")
    if wd is not None and not os.path.isdir(wd):
        raise ValueError(f"runtime_env working_dir {wd!r} is not a directory")
    pip = env.get("pip")
    if pip is not None:
        if isinstance(pip, dict):
            if "packages" not in pip:
                raise ValueError('runtime_env pip dict needs a "packages" key')
        elif not isinstance(pip, (list, tuple)):
            raise ValueError("runtime_env pip must be a list or dict")
    for key in set(env) - _KNOWN:
        plugin = rep.get_plugin(key)
        if plugin is not None:
            plugin.validate(env[key])


# ---------------------------------------------------------------------------
# pip venvs — content-addressed, created once, shared by all workers
# ---------------------------------------------------------------------------


def _runtime_env_root() -> str:
    return os.environ.get(
        "RAY_TPU_RUNTIME_ENV_DIR",
        os.path.join(os.path.expanduser("~"), ".ray_tpu", "runtime_envs"),
    )


def _pip_spec(pip) -> tuple[list[str], list[str]]:
    if isinstance(pip, dict):
        return list(pip["packages"]), list(pip.get("pip_install_options", []))
    return list(pip), []


def ensure_pip_env(pip) -> str:
    """Create (or reuse) the venv for this pip spec; returns its
    site-packages directory. Concurrent creators race on an atomic mkdir;
    losers wait for the winner's .ready marker."""
    packages, options = _pip_spec(pip)
    key = hashlib.sha1(
        json.dumps([packages, options, sys.version_info[:2]],
                   sort_keys=True).encode()
    ).hexdigest()[:16]
    env_dir = os.path.join(_runtime_env_root(), "pip", key)
    ready = os.path.join(env_dir, ".ready")
    site = os.path.join(
        env_dir, "lib",
        f"python{sys.version_info[0]}.{sys.version_info[1]}", "site-packages",
    )
    if os.path.exists(ready):
        return site
    os.makedirs(os.path.dirname(env_dir), exist_ok=True)
    lock_dir = env_dir + ".lock"
    failed = os.path.join(env_dir, ".failed")
    try:
        os.mkdir(lock_dir)  # atomic: we are the creator
    except FileExistsError:
        deadline = time.monotonic() + 300
        while not os.path.exists(ready):
            if os.path.exists(failed):
                with open(failed) as f:
                    raise RuntimeError(
                        f"pip runtime_env {key} failed to build: {f.read()}")
            # a creator killed mid-install leaves the lock forever: steal
            # stale locks (no .ready/.failed and no mtime progress) and
            # retry the build ourselves
            lock_alive = True
            try:
                age = time.time() - os.path.getmtime(lock_dir)
            except OSError:
                # lock vanished: winner just finished (ready lands next
                # poll) OR crashed between rmdir and ready — retry the
                # build ourselves rather than waiting on nothing
                lock_alive = False
                age = 0.0
            if not lock_alive and not os.path.exists(ready):
                return ensure_pip_env(pip)
            if age > 600:
                with contextlib.suppress(OSError):
                    os.rmdir(lock_dir)
                return ensure_pip_env(pip)
            if time.monotonic() > deadline:
                # a live creator refreshes the lock mtime every 30s; a long
                # (>5 min) but progressing install must not strand waiters —
                # extend the deadline while progress is visible
                if lock_alive and age < 120:
                    deadline = time.monotonic() + 120
                else:
                    raise TimeoutError(
                        f"pip runtime_env {key} not ready after 300s "
                        f"with no creator progress for {int(age)}s")
            time.sleep(0.2)
        return site
    try:
        # --system-site-packages: torch/numpy stay importable (reference pip
        # plugin default); venv pip itself installs only the requested specs
        with contextlib.suppress(OSError):
            os.remove(failed)  # we are rebuilding after a prior failure
        subprocess.run(
            [sys.executable, "-m", "venv", "--clear",
             "--system-site-packages", env_dir],
            check=True, capture_output=True,
        )
        # when THIS interpreter is itself a venv, --system-site-packages
        # exposes the base python, not our site-packages — bridge them in
        # with a .pth so build backends (setuptools) resolve inside the env
        os.makedirs(site, exist_ok=True)
        parent_sites = [p for p in sys.path if p.endswith("site-packages")]
        if parent_sites:
            with open(os.path.join(site, "_parent_site.pth"), "w") as f:
                f.write("\n".join(parent_sites) + "\n")
        vpy = os.path.join(env_dir, "bin", "python")
        cmd = [vpy, "-m", "pip", "install", "--no-warn-script-location",
               *options, *packages]
        # touch the lock while pip runs so waiters see mtime progress and
        # never steal the lock from a live (just slow) build; output goes
        # to a log file (a PIPE left undrained deadlocks chatty installs)
        log_path = os.path.join(env_dir, "pip_install.log")
        with open(log_path, "w") as log:
            proc = subprocess.Popen(cmd, stdout=log,
                                    stderr=subprocess.STDOUT, text=True)
            while True:
                try:
                    rc = proc.wait(timeout=30)
                    break
                except subprocess.TimeoutExpired:
                    with contextlib.suppress(OSError):
                        os.utime(lock_dir)
        if rc != 0:
            with open(log_path) as f:
                tail = f.read()[-2000:]
            raise RuntimeError(
                f"pip install failed for runtime_env {packages}: {tail}")
        with open(ready, "w") as f:
            f.write(json.dumps({"packages": packages, "options": options}))
        return site
    except BaseException as e:
        # leave a breadcrumb so concurrent waiters fail fast with the real
        # error instead of burning their full timeout
        with contextlib.suppress(OSError):
            os.makedirs(env_dir, exist_ok=True)
            with open(failed, "w") as f:
                f.write(str(e)[:2000])
        raise
    finally:
        with contextlib.suppress(OSError):
            os.rmdir(lock_dir)


@contextlib.contextmanager
def applied_runtime_env(env: dict | None, *, permanent: bool = False):
    """Apply env for the duration of the block; `permanent=True` (actor
    creation — the worker process is dedicated to the actor) skips the
    restore so the environment outlives the creation task."""
    if not env:
        yield
        return
    saved_env: dict[str, str | None] = {}
    saved_cwd = None
    saved_path = None
    plugin_restores: list = []
    # EVERY mutation happens inside the try: a failure mid-setup (a pip
    # install, a plugin create) must still restore the mutations already
    # made — a pooled worker keeps running other tasks afterwards
    try:
        for k, v in (env.get("env_vars") or {}).items():
            saved_env[k] = os.environ.get(k)
            os.environ[k] = str(v)
        wd = env.get("working_dir")
        if wd:
            saved_cwd = os.getcwd()
            os.chdir(wd)
        mods = list(env.get("py_modules") or [])
        if env.get("pip"):
            mods.append(ensure_pip_env(env["pip"]))
        if mods:
            saved_path = list(sys.path)
            for m in reversed(mods):
                sys.path.insert(0, m)
        # plugin-owned keys (conda/container/custom — runtime_env_plugin.py):
        # create-once resources + per-task process mutation with undo
        from ray_tpu_torch._private import runtime_env_plugin as rep

        for key in sorted(
                set(env) - _KNOWN,
                key=lambda k: getattr(rep.get_plugin(k), "priority", 10)):
            restore = rep.apply_plugin(key, env[key])
            if restore is not None:
                plugin_restores.append(restore)
        yield
    finally:
        if not permanent:
            for restore in reversed(plugin_restores):
                try:
                    restore()
                except Exception:  # noqa: BLE001 — restore is best-effort
                    pass
            for k, old in saved_env.items():
                if old is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = old
            if saved_cwd is not None:
                os.chdir(saved_cwd)
            if saved_path is not None:
                sys.path[:] = saved_path
