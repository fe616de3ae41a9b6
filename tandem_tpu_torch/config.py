"""Training config: nested YAML -> flat ``SECTION.KEY`` mapping.

Port of ``tandem_tpu/config.py`` (the reference's cva_mvsnet/config.py:8-49
semantics, so that its yaml files and CLI override lists work unchanged):

* nesting collapses into dot-joined keys (``TRAIN.LR``),
* scalar strings run through ``ast.literal_eval`` so ``"1e-4"`` / ``"(1,2)"``
  arrive typed, while non-literal strings pass through untouched,
* lists become tuples (hashable, immutable hyperparameters),
* an override may only touch a key the base mapping already has — unknown
  keys are a hard error, never a silent insert.

The machine with the card has no ``yaml`` package, so the files are read by
``parse_yaml``: the subset of YAML the config files use (block mappings by
indentation, plain and quoted scalars, ``#`` comments, flow sequences),
with PyYAML's resolution of plain scalars (YAML 1.1 booleans and nulls,
ints, floats that have a dot or are .inf/.nan; everything else a string).
A flow tuple such as ``(0.05, 0.05)`` is a plain string to YAML and becomes
a tuple through ``literal_eval``, as in the JAX package.
"""

from __future__ import annotations

import os
import re
from ast import literal_eval
from typing import Any, Dict, List, Mapping

DEFAULT_CONFIG_FILE = os.path.join(
    os.path.dirname(__file__), "configs", "default.yaml")

# PyYAML's implicit resolvers (yaml/resolver.py) for the tags a plain
# scalar of these files can take.
_BOOL = {"yes": True, "Yes": True, "YES": True, "no": False, "No": False,
         "NO": False, "true": True, "True": True, "TRUE": True,
         "false": False, "False": False, "FALSE": False, "on": True,
         "On": True, "ON": True, "off": False, "Off": False, "OFF": False}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {".inf": float("inf"), ".Inf": float("inf"),
                  ".INF": float("inf"), "+.inf": float("inf"),
                  "-.inf": float("-inf"), "-.Inf": float("-inf"),
                  "-.INF": float("-inf"), ".nan": float("nan"),
                  ".NaN": float("nan"), ".NAN": float("nan")}


def _strip_comment(line: str) -> str:
    """``line`` without a trailing ``# comment`` (a ``#`` at the start or
    after a blank, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_flow(body: str) -> List[str]:
    """The items of a flow sequence's inside, split at top-level commas."""
    items, depth, quote, start = [], 0, None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch in "[{(":
            depth += 1
        elif ch in "]})":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(body[start:i])
            start = i + 1
    items.append(body[start:])
    return [it.strip() for it in items if it.strip()]


def _scalar(text: str, where: str) -> Any:
    """One YAML scalar, typed as PyYAML's safe loader types it."""
    text = text.strip()
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"':
            raise ValueError(f"{where}: unterminated string {text!r}")
        return text[1:-1].encode("latin-1", "backslashreplace").decode(
            "unicode_escape")
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise ValueError(f"{where}: unterminated string {text!r}")
        return text[1:-1].replace("''", "'")
    if text[:1] == "[":
        if text[-1] != "]":
            raise ValueError(f"{where}: unterminated sequence {text!r}")
        return [_scalar(it, where) for it in _split_flow(text[1:-1])]
    if text[:1] in "{&*!|>%@`":
        raise ValueError(f"{where}: YAML construct {text[:1]!r} is outside "
                         "the subset this reader takes")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if text in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[text]
    if _FLOAT.match(text) and text not in (".", "+.", "-."):
        return float(text.replace("_", ""))
    return text


def parse_yaml(text: str, name: str = "<yaml>") -> Dict[str, Any]:
    """Block mappings of scalars, as ``yaml.safe_load`` reads them."""
    root: Dict[str, Any] = {}
    stack = [(-1, root)]           # (indent of the mapping's keys, mapping)
    pending = None                 # (indent, key, parent) of a key with no value
    for lineno, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{lineno}"
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError(f"{where}: tabs in indentation")
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if pending is not None:
            p_indent, p_key, p_parent = pending
            pending = None
            if indent > p_indent:          # the key opens a nested mapping
                child: Dict[str, Any] = {}
                p_parent[p_key] = child
                stack.append((indent, child))
            else:
                p_parent[p_key] = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            if stack[-1][0] == -1 and not stack[-1][1]:
                stack[-1] = (indent, root)  # the first key sets the margin
            else:
                raise ValueError(f"{where}: bad indentation")
        m = re.match(r"""("[^"]*"|'[^']*'|[^:'"]+?)\s*:(\s+|$)(.*)$""", body)
        if not m:
            raise ValueError(f"{where}: expected 'key: value', got {body!r}")
        key = _scalar(m.group(1), where)
        key = key if isinstance(key, str) else str(key)
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"{where}: duplicate key {key!r}")
        value = m.group(3).strip()
        if value:
            mapping[key] = _scalar(value, where)
        else:
            pending = (indent, key, mapping)
    if pending is not None:
        pending[2][pending[1]] = None
    return root


def _parse_value(raw: Any) -> Any:
    """Coerce one yaml/CLI value: literal-eval strings, freeze lists."""
    value = raw
    if isinstance(value, str):
        try:
            value = literal_eval(value)
        except (ValueError, SyntaxError):
            pass  # plain string (path, name, ...) — keep as-is
    return tuple(value) if isinstance(value, list) else value


def flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Collapse a nested mapping into dot-joined flat keys (iterative)."""
    flat: Dict[str, Any] = {}
    stack = [(prefix, tree)]
    while stack:
        path, node = stack.pop()
        for key, value in node.items():
            dotted = f"{path}{key}"
            if isinstance(value, Mapping):
                stack.append((dotted + ".", value))
            else:
                flat[dotted] = _parse_value(value)
    return flat


def load(fname: str) -> Dict[str, Any]:
    with open(fname, "r") as fp:
        return flatten(parse_yaml(fp.read(), fname))


def merge_from_config(config: Dict[str, Any],
                      overrides: Mapping[str, Any]) -> None:
    """Apply overrides in place; every key must already exist in config."""
    unknown = [k for k in overrides if k not in config]
    if unknown:
        raise KeyError(
            f"Refusing to merge unknown config key(s) {unknown}: overrides "
            "may only change keys present in the base config.")
    config.update(overrides)


def merge_from_file(config: Dict[str, Any], fname: str) -> None:
    merge_from_config(config, load(fname))


def merge_from_list(config: Dict[str, Any], kv_list: List[str]) -> None:
    """Apply a CLI tail of alternating KEY VALUE tokens."""
    if len(kv_list) % 2:
        raise ValueError(
            f"Override list needs alternating KEY VALUE tokens, got an odd "
            f"count ({len(kv_list)}).")
    keys, values = kv_list[0::2], kv_list[1::2]
    merge_from_config(config, {k: _parse_value(v)
                               for k, v in zip(keys, values)})


def default() -> Dict[str, Any]:
    """The full base config (every known key) from configs/default.yaml."""
    return load(DEFAULT_CONFIG_FILE)


def rendezvous(environ: Mapping[str, str] = os.environ):
    """``TRAIN.DEVICE multihost``'s process group from the environment:
    (init_method, world, rank). The JAX CLI's variables first
    (``TANDEM_COORDINATOR`` host:port, ``TANDEM_NUM_PROCESSES``,
    ``TANDEM_PROCESS_ID``; tandem_tpu/cli/tandem_train.py:64-74), else
    torchrun's (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``)."""
    if environ.get("TANDEM_COORDINATOR"):
        return (f"tcp://{environ['TANDEM_COORDINATOR']}",
                int(environ["TANDEM_NUM_PROCESSES"]),
                int(environ["TANDEM_PROCESS_ID"]))
    if environ.get("MASTER_ADDR") and environ.get("WORLD_SIZE"):
        return (f"tcp://{environ['MASTER_ADDR']}:{environ['MASTER_PORT']}",
                int(environ["WORLD_SIZE"]), int(environ["RANK"]))
    raise RuntimeError(
        "TRAIN.DEVICE multihost: no rendezvous in the environment; set "
        "TANDEM_COORDINATOR, TANDEM_NUM_PROCESSES and TANDEM_PROCESS_ID "
        "(or launch with torchrun)")


def train_device(config: Mapping[str, Any], rank: int = 0):
    """The torch device of ``TRAIN.DEVICE`` for data-parallel rank
    ``rank``: ``cuda`` the current card, ``cpu`` the CPU, ``mesh`` card
    ``rank`` (one rank a visible card), ``multihost`` card ``LOCAL_RANK``
    (torchrun's) or ``rank``, modulo the visible cards; under
    ``TANDEM_PLATFORM=cpu`` (the JAX launcher's variable) multihost ranks
    run on the CPU. Every mode but ``cpu`` raises without a card."""
    import torch
    mode = config["TRAIN.DEVICE"]
    if mode not in ("cpu", "cuda", "mesh", "multihost"):
        raise ValueError(f"TRAIN.DEVICE {mode!r}: tandem_tpu_torch trains "
                         "on cuda, cpu, mesh or multihost")
    if mode == "cpu" or (mode == "multihost" and os.environ.get(
            "TANDEM_PLATFORM") == "cpu"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"TRAIN.DEVICE {mode}: no CUDA device; pass "
                           "TRAIN.DEVICE cpu to train on the CPU")
    if mode == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    if mode == "multihost":
        rank = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", rank % torch.cuda.device_count())
