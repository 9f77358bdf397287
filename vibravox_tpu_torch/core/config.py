"""Hydra-compatible configuration subsystem (the port's copy).

The port's own copy of ``vibravox_tpu/core/config.py``, which needs only
PyYAML.  The reference framework composes its runs from a tree of YAML
config groups with a Hydra ``defaults`` list, ``_target_`` instantiation,
``${...}`` interpolation and a CLI override grammar (``group=option``,
``+key=val``, ``++key=val``, ``~key``, dotted paths); this module implements
the subset of Hydra 1.3 semantics that the config tree uses, so the same
CLI surface drives the port (``vibravox_tpu_torch/run.py``).

Public API:
    compose(config_dir, config_name, overrides) -> Config
    instantiate(node, **kwargs) -> object
    Config: a dict/attr hybrid with dotted access
"""

from __future__ import annotations

import copy
import datetime
import importlib
import functools
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import yaml

__all__ = ["Config", "compose", "instantiate", "to_container", "MISSING"]

MISSING = "???"


class Config(dict):
    """A dict with attribute access and dotted-path get/set, à la OmegaConf."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def select(self, path: str, default: Any = None) -> Any:
        node: Any = self
        for part in path.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            elif isinstance(node, (list, tuple)) and part.lstrip("-").isdigit():
                node = node[int(part)]
            else:
                return default
        return node

    def set_path(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node: Any = self
        for part in parts[:-1]:
            if isinstance(node, dict):
                if part not in node or not isinstance(node[part], (dict, list)):
                    node[part] = Config()
                node = node[part]
            elif isinstance(node, list):
                node = node[int(part)]
        if isinstance(node, list):
            node[int(parts[-1])] = value
        else:
            node[parts[-1]] = value

    def has_path(self, path: str) -> bool:
        sentinel = object()
        return self.select(path, sentinel) is not sentinel


def _wrap(node: Any) -> Any:
    """Recursively convert plain dicts to Config."""
    if isinstance(node, Config):
        return Config({k: _wrap(v) for k, v in node.items()})
    if isinstance(node, dict):
        return Config({k: _wrap(v) for k, v in node.items()})
    if isinstance(node, list):
        return [_wrap(v) for v in node]
    return node


def to_container(node: Any) -> Any:
    """Recursively convert a Config tree to plain python containers."""
    if isinstance(node, dict):
        return {k: to_container(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [to_container(v) for v in node]
    return node


def _merge(dst: Config, src: Dict[str, Any]) -> Config:
    """Deep-merge src into dst (src wins); dicts merge, everything else replaces."""
    for key, value in src.items():
        if key in dst and isinstance(dst[key], dict) and isinstance(value, dict):
            _merge(dst[key], value)
        else:
            dst[key] = _wrap(value)
    return dst


# --------------------------------------------------------------------------- #
# YAML loading
# --------------------------------------------------------------------------- #


class _Yaml12Loader(yaml.SafeLoader):
    """SafeLoader with YAML 1.2 float resolution (``3e-4`` is a float, as
    Hydra/OmegaConf treat it; pyyaml's 1.1 resolver requires a dot)."""


_Yaml12Loader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


def _load_yaml(path: Path) -> Config:
    with open(path) as f:
        data = yaml.load(f, Loader=_Yaml12Loader)
    if data is None:
        data = {}
    if not isinstance(data, dict):
        raise ValueError(f"Config file {path} must contain a mapping at top level")
    return _wrap(data)


# --------------------------------------------------------------------------- #
# Override grammar (the subset of Hydra's used by the reference README recipes)
# --------------------------------------------------------------------------- #


def _parse_value(text: str) -> Any:
    """Parse a CLI value with YAML semantics (numbers, bools, null, lists)."""
    if text == "":
        return ""
    try:
        return yaml.load(text, Loader=_Yaml12Loader)
    except yaml.YAMLError:
        return text


class Override:
    """One CLI override: ``[+|++|~]key=value`` or ``group=option``."""

    def __init__(self, raw: str):
        self.raw = raw
        self.force_add = raw.startswith("++")
        self.add = raw.startswith("+") and not self.force_add
        self.delete = raw.startswith("~")
        body = raw.lstrip("+~")
        if "=" in body:
            self.key, value_text = body.split("=", 1)
            self.value = _parse_value(value_text)
        else:
            self.key, self.value = body, None
        # group@pkg renaming (e.g. optimizer@generator_optimizer)
        if "@" in self.key:
            self.group, self.package = self.key.split("@", 1)
        else:
            self.group = self.key
            self.package = self.key


# --------------------------------------------------------------------------- #
# Defaults-list composition
# --------------------------------------------------------------------------- #


def _iter_defaults(defaults: List[Any]) -> List[Tuple[str, str, Optional[str]]]:
    """Normalize a Hydra defaults list to (group, option, package) triples.

    ``_self_`` is encoded as ("_self_", "", None).
    """
    out: List[Tuple[str, str, Optional[str]]] = []
    for item in defaults:
        if item == "_self_":
            out.append(("_self_", "", None))
        elif isinstance(item, str):
            out.append((item, "", None))
        elif isinstance(item, dict):
            for key, value in item.items():
                if "@" in key:
                    group, package = key.split("@", 1)
                else:
                    group, package = key, None
                if isinstance(value, list):
                    for option in value:
                        out.append((group, option, package))
                else:
                    out.append((group, value, package))
        else:
            raise ValueError(f"Unsupported defaults entry: {item!r}")
    return out


class _Composer:
    def __init__(self, config_dir: Path, overrides: List[Override]):
        self.config_dir = Path(config_dir)
        self.overrides = overrides
        # group -> chosen option (for ${hydra:runtime.choices.*})
        self.choices: Dict[str, str] = {}
        self.used_group_overrides: set = set()

    def _group_overrides(self) -> Dict[str, Override]:
        return {
            o.key: o
            for o in self.overrides
            if not o.add and not o.force_add and o.value is not None
            and isinstance(o.value, str)
            and (self.config_dir / o.group.replace(".", "/")).is_dir()
        }

    def compose_file(self, rel_path: str, package_path: str = "") -> Config:
        """Load one YAML and process its defaults list recursively.

        ``package_path`` is the absolute package this config lands at —
        nested default groups match CLI overrides in Hydra's absolute form
        ``group/subgroup@abs.package=option``.
        """
        path = self.config_dir / (rel_path + ".yaml")
        if not path.exists():
            raise FileNotFoundError(f"Config not found: {path}")
        node = _load_yaml(path)
        defaults = node.pop("defaults", None)
        if defaults is None:
            return node

        group_overrides = self._group_overrides()
        base_dir = str(Path(rel_path).parent)
        composed = Config()
        self_merged = False
        for group, option, package in _iter_defaults(defaults):
            if group == "_self_":
                _merge(composed, node)
                self_merged = True
                continue
            # apply CLI group override (absolute group path key)
            abs_group = group if base_dir in (".", "") else f"{base_dir}/{group}"
            choice_key = abs_group.replace("/", ".")
            target_pkg = package if package is not None else group.split("/")[-1]
            abs_pkg = ".".join(p for p in (package_path, target_pkg) if p)
            # accepted CLI keys for this entry, most specific first:
            # Hydra's absolute form (slash group @ absolute package), then
            # legacy dotted forms
            candidates = [f"{abs_group}@{abs_pkg}"]
            if package:
                candidates.append(f"{choice_key}@{package}")
            else:
                candidates += [abs_group, choice_key]
            for key in candidates:
                if key in group_overrides:
                    option = group_overrides[key].value
                    self.used_group_overrides.add(key)
                    break
            if option in (None, "null"):
                continue
            self.choices[choice_key] = str(option)
            sub_pkg = abs_pkg if target_pkg != "_global_" else package_path
            sub = self.compose_file(f"{abs_group}/{option}", sub_pkg)
            if target_pkg in ("_global_",):
                _merge(composed, sub)
            else:
                holder = composed
                for part in target_pkg.split("."):
                    holder = holder.setdefault(part, Config())
                _merge(holder, sub)
        if not self_merged:
            _merge(composed, node)
        return composed


# --------------------------------------------------------------------------- #
# Interpolation
# --------------------------------------------------------------------------- #

_INTERP_RE = re.compile(r"\$\{([^{}]+)\}")


def _resolve_node(root: Config, value: Any, seen: Tuple[str, ...] = ()) -> Any:
    if isinstance(value, str):
        matches = list(_INTERP_RE.finditer(value))
        if not matches:
            return value
        # Full-string interpolation keeps the referenced value's type
        if len(matches) == 1 and matches[0].span() == (0, len(value)):
            return _resolve_ref(root, matches[0].group(1), seen)

        def sub(m: "re.Match[str]") -> str:
            resolved = _resolve_ref(root, m.group(1), seen)
            return str(resolved)

        return _INTERP_RE.sub(sub, value)
    return value


def _resolve_ref(root: Config, ref: str, seen: Tuple[str, ...]) -> Any:
    ref = ref.strip()
    if ref in seen:
        raise ValueError(f"Circular interpolation at ${{{ref}}}")
    if ref.startswith("hydra:"):
        return root.select("hydra_runtime." + ref[len("hydra:"):].strip(), f"${{{ref}}}")
    if ref.startswith("now:"):
        return datetime.datetime.now().strftime(ref[len("now:"):])
    if ref.startswith("oc.env:"):
        import os

        parts = ref[len("oc.env:"):].split(",", 1)
        return os.environ.get(parts[0].strip(), parts[1].strip() if len(parts) > 1 else None)
    sentinel = object()
    value = root.select(ref, sentinel)
    if value is sentinel:
        raise KeyError(f"Interpolation key not found: {ref}")
    return _resolve_node(root, value, seen + (ref,))


def resolve(root: Config) -> Config:
    """Resolve all ``${...}`` interpolations in-place (returns root)."""

    def walk(node: Any) -> Any:
        if isinstance(node, dict):
            for k in list(node.keys()):
                node[k] = walk(node[k])
            return node
        if isinstance(node, list):
            return [walk(v) for v in node]
        return _resolve_node(root, node)

    walk(root)
    return root


# --------------------------------------------------------------------------- #
# Public composition entry
# --------------------------------------------------------------------------- #


def compose(
    config_dir: str | Path,
    config_name: str = "run",
    overrides: Optional[List[str]] = None,
    resolve_interpolations: bool = True,
) -> Config:
    """Compose a config like ``hydra.compose`` would.

    Args:
        config_dir: root directory of the config tree.
        config_name: name of the primary config (without ``.yaml``).
        overrides: CLI-style override strings.
        resolve_interpolations: resolve ``${...}`` after composition.
    """
    parsed = [Override(o) for o in (overrides or [])]
    composer = _Composer(Path(config_dir), parsed)
    cfg = composer.compose_file(config_name)

    unused = set(composer._group_overrides()) - composer.used_group_overrides
    if unused:
        raise ValueError(
            f"Group override(s) matched no defaults entry: {sorted(unused)} "
            "(for nested groups use group/subgroup@absolute.package=option)"
        )

    # value overrides (after composition, Hydra semantics)
    for o in parsed:
        if o.delete:
            parts = o.key.split(".")
            parent = cfg.select(".".join(parts[:-1])) if len(parts) > 1 else cfg
            if isinstance(parent, dict):
                parent.pop(parts[-1], None)
            continue
        if (Path(config_dir) / o.group.replace(".", "/")).is_dir():
            continue  # group override — already consumed during composition
        if o.add and cfg.has_path(o.key):
            raise ValueError(f"Override '+{o.key}' but key already exists; use '++'")
        cfg.set_path(o.key, _wrap(o.value))

    cfg["hydra_runtime"] = _wrap(
        {"runtime": {"choices": {k.replace("/", "."): v for k, v in composer.choices.items()}}}
    )
    if resolve_interpolations:
        resolve(cfg)
    cfg.pop("hydra_runtime", None)
    return cfg


# --------------------------------------------------------------------------- #
# Instantiation (_target_ / _partial_)
# --------------------------------------------------------------------------- #


def _locate(target: str) -> Any:
    parts = target.split(".")
    for split in range(len(parts) - 1, 0, -1):
        module_name = ".".join(parts[:split])
        try:
            obj: Any = importlib.import_module(module_name)
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
            return obj
        except AttributeError:
            continue
    raise ImportError(f"Cannot locate target: {target}")


def instantiate(node: Any, *args: Any, **kwargs: Any) -> Any:
    """Hydra-style recursive instantiation of ``_target_`` nodes."""
    if isinstance(node, (list, tuple)):
        return [instantiate(v) for v in node]
    if not isinstance(node, dict):
        return node
    if "_target_" not in node:
        return Config({k: instantiate(v) for k, v in node.items()})

    node = dict(node)
    target = node.pop("_target_")
    partial = bool(node.pop("_partial_", False))
    node.pop("_recursive_", None)
    node.pop("_convert_", None)
    pos_args = [instantiate(a) for a in node.pop("_args_", [])]
    call_kwargs = {k: instantiate(v) for k, v in node.items()}
    call_kwargs.update(kwargs)
    fn = _locate(target)
    if partial:
        return functools.partial(fn, *pos_args, *args, **call_kwargs)
    return fn(*pos_args, *args, **call_kwargs)
