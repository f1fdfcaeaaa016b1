"""Shared CLI plumbing: logging, `--preset` / `--set` config resolution
and the `--device` flag (the JAX package's `--platform`)."""

from __future__ import annotations

import argparse
import ast
import logging
from typing import Any, Dict, Optional

from multimodal_rare_disease_tpu_torch.config import (
    PRESETS,
    Config,
    resolve_config,
)


def setup_logging(verbose: bool = True) -> None:
    logging.basicConfig(
        level=logging.INFO if verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        datefmt="%H:%M:%S",
    )


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device, e.g. cuda, cuda:1 or cpu "
                             "(default: the card; without one it fails "
                             "unless cpu is asked for)")


def add_config_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--preset", default=None, choices=sorted(PRESETS),
                        help="config preset (default: inferred from mode)")
    parser.add_argument("--set", dest="overrides", action="append",
                        default=[], metavar="KEY=VALUE",
                        help="config override, e.g. "
                             "--set training.batch_size=16")
    add_device_arg(parser)


def build_config(args: argparse.Namespace, mode: str,
                 extra: Optional[Dict[str, Any]] = None) -> Config:
    preset = args.preset
    if preset is None:
        preset = {"multimodal": "multimodal", "image_only": "small_data",
                  "text_only": "default"}.get(mode, "default")
    overrides: Dict[str, Any] = dict(extra or {})
    for item in getattr(args, "overrides", []):
        if "=" not in item:
            raise SystemExit(f"--set expects KEY=VALUE, got {item!r}")
        key, value = item.split("=", 1)
        try:
            overrides[key] = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            overrides[key] = value
    return resolve_config(preset, overrides)
