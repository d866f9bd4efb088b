"""Names of the JAX package the port has not ported yet.

A :class:`NotPorted` stands where the JAX package has a function, class
or subpackage that waits for a later item of ROADMAP.md: calling it, or
reading an attribute of it, raises ``NotImplementedError`` naming
ROADMAP.md. So the name is present and never silently missing.
"""

from __future__ import annotations


class NotPorted:
    def __init__(self, name: str, source: str):
        self.__name__ = name
        self._source = source
        self.__doc__ = (f"Not ported yet: ``{source}`` (ROADMAP.md, Queue "
                        f"1).")

    def _raise(self):
        raise NotImplementedError(
            f"paddle_tpu_torch: {self.__name__} ({self._source}) is not "
            f"ported yet; see ROADMAP.md, Queue 1")

    def __call__(self, *args, **kwargs):
        self._raise()

    def __getattr__(self, attr):
        if attr.startswith("__") and attr.endswith("__"):
            raise AttributeError(attr)
        self._raise()

    def __repr__(self) -> str:
        return f"<not ported: {self.__name__} ({self._source})>"
