"""Pipeline recipes (port of pfb_imaging_tpu/recipes.py): declarative
multi-step runs over the ``pfb-torch`` command set, run in-process with
``--device`` added to every step. The recipe files are the JAX package's
(``recipes/sara.yml``).

Recipe format::

    name: sara-pipeline
    steps:
      - command: simulate
        args: {output: "{out}/sim.ms.tree", nant: 12}
      - command: init
        args: {ms: "{out}/sim.ms.tree", output: "{out}/sim_I.xds"}
      ...

``{out}`` (and any other ``params``) are substituted into string values.
"""

from __future__ import annotations

import json
from pathlib import Path


def _substitute(value, params: dict):
    if isinstance(value, str):
        for k, v in params.items():
            value = value.replace("{" + k + "}", str(v))
        return value
    if isinstance(value, dict):
        return {k: _substitute(v, params) for k, v in value.items()}
    if isinstance(value, list):
        return [_substitute(v, params) for v in value]
    return value


def load_recipe(path: str) -> dict:
    text = Path(path).read_text()
    if path.endswith(".json"):
        return json.loads(text)
    # minimal YAML subset (mappings, lists of mappings, scalars) — recipes
    # are simple; a full YAML parser is not in this image
    try:
        import yaml  # type: ignore

        return yaml.safe_load(text)
    except ImportError:
        return _mini_yaml(text)


def _mini_yaml(text: str):
    """Parse the tiny YAML subset used by recipe files."""
    import re

    def parse_scalar(s: str):
        s = s.strip()
        if s.startswith("{") and s.endswith("}"):
            out = {}
            for part in _split_top(s[1:-1]):
                k, v = part.split(":", 1)
                out[k.strip()] = parse_scalar(v)
            return out
        if re.fullmatch(r"-?\d+", s):
            return int(s)
        try:
            if re.fullmatch(r"[-+0-9.eE]+", s):
                return float(s)
        except ValueError:
            pass
        if s in ("true", "True"):
            return True
        if s in ("false", "False"):
            return False
        return s.strip("\"'")

    def _split_top(s: str):
        parts, depth, cur = [], 0, ""
        for ch in s:
            if ch == "{":
                depth += 1
            if ch == "}":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        if cur.strip():
            parts.append(cur)
        return parts

    root: dict = {}
    steps = None
    current = None
    for raw in text.splitlines():
        if not raw.strip() or raw.strip().startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip())
        line = raw.strip()
        if indent == 0:
            if line.startswith("steps:"):
                steps = []
                root["steps"] = steps
            else:
                k, v = line.split(":", 1)
                root[k.strip()] = parse_scalar(v)
        elif line.startswith("- "):
            current = {}
            steps.append(current)
            rest = line[2:]
            if rest:
                k, v = rest.split(":", 1)
                current[k.strip()] = parse_scalar(v)
        else:
            k, v = line.split(":", 1)
            current[k.strip()] = parse_scalar(v)
    return root


def run_recipe(path: str, params: dict | None = None, *, device="cuda") -> None:
    """Execute a recipe through the port's CLI (in-process), every step on
    ``device``."""
    from .cli import main as cli_main

    recipe = load_recipe(path)
    params = dict(recipe.get("params", {}), **(params or {}))
    for step in recipe["steps"]:
        step = _substitute(step, params)
        argv = [step["command"]]
        for k, v in step.get("args", {}).items():
            if isinstance(v, bool):
                if v:
                    argv.append(f"--{k.replace('_', '-')}")
            elif k in ("ms", "output", "xds", "dt", "mds"):
                argv.append(str(v))
            else:
                argv.extend([f"--{k.replace('_', '-')}", str(v)])
        cli_main(argv + ["--device", str(device)])
