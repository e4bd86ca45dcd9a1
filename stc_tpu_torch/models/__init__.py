"""Model registry of stc_tpu_torch (the port's copy of
``stc_tpu/models/__init__.py``): each loader registers under a name; the
session runtime only sees the streaming API."""

MODEL_REGISTRY = {}


def register_model(name):
    def deco(fn):
        MODEL_REGISTRY[name] = fn
        return fn
    return deco
