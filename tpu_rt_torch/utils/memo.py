"""Values kept for an object while it lives.

What a frame or a walk needs that depends on one object alone (a scene's
packed tables and rays, a grid's host copy, a geometry's CUDA graph) is
made once for that object, not every call.  An entry is keyed by the
object's ``id`` and dropped by a ``weakref`` callback when the object is
collected, so a later object at the same address never finds it.
"""

from __future__ import annotations

import weakref

_KEPT = {}


def per_object(obj, key, make, version=None):
    """``make()``, kept for ``obj`` and ``key`` while ``obj`` lives and,
    where ``version`` is given (a tensor's ``_version``), while it is the
    version it was made at.  Scenes are immutable (``replace`` makes a new
    one), so what is kept for them stays right."""
    k = (id(obj), key)
    hit = _KEPT.get(k)
    if hit is not None and hit[0]() is obj and hit[1] == version:
        return hit[2]
    value = make()
    _KEPT[k] = (weakref.ref(obj, lambda _, k=k: _KEPT.pop(k, None)), version, value)
    return value
