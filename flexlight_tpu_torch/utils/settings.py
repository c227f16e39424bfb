"""Config/engine-switch persistence — the localStorage analogue.

The port's own copy of flexlight_tpu/utils/settings.py (flexlight_tpu_torch
imports nothing of the JAX package), in the same JSON layout, so a file
written by either package loads in the other. The reference's loader
persists the quality knobs and engine switches in `localStorage` and
restores them on page load (loader.js:25-52, 65-93); here the same set —
renderer/api plus every Config field — round-trips through a JSON file.

The default file is ~/.flexlight_tpu_torch.json; no environment variable
moves it (pass `path`).
"""

from __future__ import annotations

import dataclasses
import json
import os

from ..config import Config

DEFAULT_PATH = os.path.expanduser("~/.flexlight_tpu_torch.json")

def save_settings(config: Config, renderer: str | None = None,
                  api: str | None = None, path: str = DEFAULT_PATH) -> None:
    """Persist config knobs (+ optional engine switches) as JSON."""
    data = {"config": dataclasses.asdict(config)}
    if renderer is not None:
        data["renderer"] = renderer
    if api is not None:
        data["api"] = api
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
    os.replace(tmp, path)


def load_settings(path: str = DEFAULT_PATH, base: Config | None = None):
    """Returns (config, renderer | None, api | None); missing file or
    unknown fields fall back to defaults (localStorage ?? default,
    loader.js:26-43)."""
    base = base if base is not None else Config()
    if not os.path.exists(path):
        return base, None, None
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return base, None, None
    known = {f.name for f in dataclasses.fields(Config)}
    fields = {k: v for k, v in data.get("config", {}).items() if k in known}
    try:
        config = dataclasses.replace(base, **fields)
    except (TypeError, ValueError):
        config = base
    return config, data.get("renderer"), data.get("api")


def apply_settings(engine, path: str = DEFAULT_PATH) -> None:
    """Restore persisted switches onto a FlexLight engine (loader.js:29)."""
    config, renderer, api = load_settings(path, base=engine.config)
    engine.config = config
    if api is not None:
        engine.api = api
    if renderer is not None:
        engine.renderer = renderer
