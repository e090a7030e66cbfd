"""Global configuration tree with dotted-path access and overrides.

The port's own copy of `veles_tpu/config.py` (the port imports nothing of
the JAX package). Parity: reference `veles/config.py` (`Config`, global
`root`) — a tree of config nodes where samples write
`root.mnist.loader.minibatch_size = 60`,
`Config.update(dict)` merges nested dicts, and CLI trailing arguments of the
form `root.path.to.key=value` are applied as overrides.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, Iterator, Tuple


class Config:
    """A node in the config tree.

    Attribute reads auto-vivify child ``Config`` nodes, so
    ``root.a.b.c = 1`` works without declaring ``a`` or ``b`` first.
    """

    __slots__ = ("__dict__", "_path")

    def __init__(self, path: str = "", **kwargs: Any) -> None:
        object.__setattr__(self, "_path", path)
        for k, v in kwargs.items():
            setattr(self, k, v)

    # -- tree access ---------------------------------------------------------

    def __getattr__(self, name: str) -> Any:
        # Only called when the attribute is missing: auto-vivify a child node.
        if name.startswith("_"):
            raise AttributeError(name)
        child = Config(path=f"{self._path}.{name}" if self._path else name)
        self.__dict__[name] = child
        return child

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, dict):
            node = Config(path=f"{self._path}.{name}" if self._path else name)
            node.update(value)
            value = node
        self.__dict__[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self.__dict__

    def get(self, name: str, default: Any = None) -> Any:
        """Read a key without auto-vivifying it."""
        return self.__dict__.get(name, default)

    # -- merging / overrides -------------------------------------------------

    def update(self, other: Any) -> "Config":
        """Deep-merge a nested dict (or another Config) into this node."""
        items = other.items() if isinstance(other, (dict, Config)) else other
        for k, v in items:
            if isinstance(v, (dict, Config)):
                existing = self.__dict__.get(k)
                if isinstance(existing, Config):
                    existing.update(v)
                else:
                    setattr(self, k, dict(v.items())
                            if isinstance(v, Config) else v)
            else:
                setattr(self, k, v)
        return self

    def override(self, dotted: str, value: Any) -> None:
        """Apply one `a.b.c=value` override below this node."""
        *parents, leaf = dotted.split(".")
        node = self
        for p in parents:
            node = getattr(node, p)
            if not isinstance(node, Config):
                raise TypeError(
                    f"config path {dotted!r}: {p!r} is a leaf, cannot descend")
        setattr(node, leaf, value)

    # -- introspection -------------------------------------------------------

    def items(self) -> Iterator[Tuple[str, Any]]:
        return iter(self.__dict__.items())

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: v.to_dict() if isinstance(v, Config) else v
            for k, v in self.__dict__.items()
        }

    def __repr__(self) -> str:
        return f"Config({self._path or 'root'}: {self.to_dict()!r})"

    # Pickling: __getattr__ auto-vivification confuses default protocol.
    def __getstate__(self):
        return (self._path, self.__dict__.copy())

    def __setstate__(self, state):
        path, d = state
        object.__setattr__(self, "_path", path)
        self.__dict__.update(d)


def parse_override(arg: str) -> Tuple[str, Any]:
    """Parse a CLI override `root.a.b=expr` (the `root.` prefix is optional).

    The value is evaluated with ``ast.literal_eval`` when possible, else kept
    as a string — mirrors the reference CLI which exec'd trailing args.
    """
    if "=" not in arg:
        raise ValueError(f"override {arg!r} must look like root.a.b=value")
    path, _, raw = arg.partition("=")
    path = path.strip()
    if path.startswith("root."):
        path = path[len("root."):]
    try:
        value = ast.literal_eval(raw.strip())
    except (ValueError, SyntaxError):
        value = raw.strip()
    return path, value


#: The global configuration tree every sample/config module mutates.
root = Config()

# Common defaults (parity: reference `veles/config.py` root.common.*).
#: the fused step's compute dtype: "float32", or "bfloat16" for bf16
#: compute over f32 master weights (parallel/fused.py); the server takes
#: float32 only (serving.py checks it)
root.common.precision_type = "float32"
