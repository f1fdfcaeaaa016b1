"""Shared CLI plumbing: logging, `--preset` / `--set` config resolution,
the `--device` flag (the JAX package's `--platform`) and the rank mesh's
`--mesh DPxTP` / `--backend` flags."""

from __future__ import annotations

import argparse
import ast
import logging
from typing import Any, Dict, Optional, Tuple

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


def add_mesh_args(parser: argparse.ArgumentParser, what: str) -> None:
    parser.add_argument("--mesh", default=None, metavar="DPxTP",
                        help=f"{what} over a rank mesh, e.g. '4x1' = the "
                        f"batch split over 4 ranks, '4x2' adds Megatron TP "
                        f"of the text tower over 2 (parallel/tp.py); the "
                        f"command starts the ranks itself; default one "
                        f"process")
    parser.add_argument("--backend", default="nccl",
                        choices=["nccl", "gloo"],
                        help="process-group backend of --mesh: nccl for "
                        "ranks on cards of their own, gloo for ranks that "
                        "share a card or run on the CPU")


def parse_mesh(parser: argparse.ArgumentParser, spec: str
               ) -> Tuple[int, int]:
    """'DPxTP' → (data, model), with the JAX `--mesh` parsing and text."""
    dp, _, tp = spec.lower().partition("x")
    try:
        return int(dp), int(tp or 1)
    except ValueError:
        parser.error(f"--mesh {spec!r}: expected DPxTP, e.g. "
                     "'4x1' or '4x2'")
