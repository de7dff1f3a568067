"""Model multiplexing: many models per replica with LRU residency (the
port's copy of ``ray_tpu/serve/multiplex.py``).

Equivalent of the reference's serve multiplexing
(reference: python/ray/serve/multiplex.py — @serve.multiplexed loader with
max_num_models_per_replica LRU). Note: evicting a model frees its device
memory only once all its tensors are dropped, so the loader should
return tensors owned solely by the cache entry.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable


class _MultiplexedLoader:
    def __init__(self, loader: Callable[[str], Any], max_num_models: int):
        self._loader = loader
        self._max = max_num_models
        self._lock = threading.Lock()
        self._models: "OrderedDict[str, Any]" = OrderedDict()

    def __call__(self, model_id: str) -> Any:
        with self._lock:
            model = self._models.get(model_id)
            if model is not None:
                self._models.move_to_end(model_id)
                return model
        # load OUTSIDE the lock (loads are slow)
        model = self._loader(model_id)
        to_unload = []
        with self._lock:
            existing = self._models.get(model_id)
            if existing is not None:
                # lost a racing load: keep the cached one, drop our copy so
                # its device buffers (HBM) free promptly
                self._models.move_to_end(model_id)
                to_unload.append(model)
                model = existing
            else:
                self._models[model_id] = model
                while len(self._models) > self._max:
                    _, old = self._models.popitem(last=False)
                    to_unload.append(old)
        for m in to_unload:
            unload = getattr(m, "unload", None)
            if callable(unload):
                unload()
        return model

    @property
    def resident_models(self) -> list[str]:
        with self._lock:
            return list(self._models)


def multiplexed(
    _loader: Callable | None = None, *, max_num_models_per_replica: int = 3
):
    """Wrap a model-loading function with per-replica LRU residency:

        @serve.deployment
        class M:
            def __init__(self):
                self.get_model = serve.multiplexed(
                    load_model, max_num_models_per_replica=3)
            def __call__(self, req):
                return self.get_model(req["model_id"]).predict(req["x"])
    """

    def wrap(loader):
        return _MultiplexedLoader(loader, max_num_models_per_replica)

    return wrap if _loader is None else wrap(_loader)
