"""Declarative Serve deploys from config files.

Analog of the reference's `serve deploy` YAML path (serve/scripts.py:256 +
the Serve REST schema): a config file names applications by import path
with deployment overrides; `serve.run_from_config` builds and deploys
them. JSON is first-class (always stdlib); YAML is used when PyYAML is
present in the image.

Config shape (mirrors the reference's ServeDeploySchema subset):

    {
      "applications": [
        {
          "name": "summarizer",
          "import_path": "my_module:app",       # module:attribute
          "args": {"init": "kwargs"},           # optional bind overrides
          "deployments": [
            {"name": "Summarizer", "num_replicas": 2,
             "max_ongoing_requests": 16,
             "ray_actor_options": {"num_gpus": 1},
             "slo": {"ttft_ms": 200, "e2e_ms": 2000,
                     "objective": 0.99}}       # observatory SLO targets
          ]
        }
      ],
      "http": {"host": "127.0.0.1", "port": 8000}   # optional proxy
    }
"""

from __future__ import annotations

import importlib
import json
import os
from typing import Any, Dict, List


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        text = f.read()
    if path.endswith((".yaml", ".yml")):
        try:
            import yaml

            return yaml.safe_load(text)
        except ImportError as e:
            raise RuntimeError(
                "YAML config requires PyYAML; use a .json config instead"
            ) from e
    return json.loads(text)


def _import_attr(import_path: str):
    if ":" not in import_path:
        raise ValueError(
            f"import_path must be 'module:attribute', got {import_path!r}"
        )
    mod_name, attr = import_path.split(":", 1)
    mod = importlib.import_module(mod_name)
    return getattr(mod, attr)


def build_application(app_cfg: Dict[str, Any]):
    """Resolve an application entry to a bound Application."""
    from ray_tpu_torch.serve.deployment import Application, Deployment

    target = _import_attr(app_cfg["import_path"])
    args = app_cfg.get("args") or {}
    if isinstance(target, Application):
        app = target
    elif isinstance(target, Deployment):
        app = target.bind(**args)
    elif callable(target):  # builder fn taking the args dict
        app = target(**args) if args else target()
        if isinstance(app, Deployment):
            app = app.bind()
    else:
        raise TypeError(
            f"{app_cfg['import_path']} resolved to {type(target).__name__}; "
            "expected an Application, Deployment, or builder function"
        )
    # Per-deployment overrides.
    for dep_over in app_cfg.get("deployments") or ():
        if dep_over.get("name") not in (None, app.deployment.name):
            continue
        overrides = {k: v for k, v in dep_over.items() if k != "name"}
        app = type(app)(
            app.deployment.options(**overrides), app.init_args,
            app.init_kwargs,
        )
    return app


def run_from_config(path_or_dict, _blocking: bool = False) -> Dict[str, Any]:
    """Deploy every application in the config; returns {name: handle}."""
    from ray_tpu_torch import serve

    cfg = (
        load_config(path_or_dict)
        if isinstance(path_or_dict, (str, os.PathLike))
        else path_or_dict
    )
    handles = {}
    for app_cfg in cfg.get("applications", ()):
        app = build_application(app_cfg)
        name = app_cfg.get("name") or app.deployment.name
        handles[name] = serve.run(app, name=name)
    http = cfg.get("http")
    if http:
        serve.start_http_proxy(
            host=http.get("host", "127.0.0.1"), port=http.get("port", 8000)
        )
    return handles
