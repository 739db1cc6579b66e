"""Preset system — the port's copy of `afp_tpu/engine/presets.py` over the
port's `StreamConfig` (SURVEY.md §5.4; `tests/test_torch_cli.py` holds the
JSON the two write byte for byte).

Re-creates the reference's preset capability
(`stream_process_GUI_Presets.py:143-195, 239-240`): named
snapshots of EQ gains + filter settings, explicitly *excluding* samplerate
and blocksize (`:163-164` — those are deployment properties, not sound
presets).  The reference keeps presets only in memory; here they also
round-trip to JSON on disk, the promised upgrade.

On-disk schema is versioned (``{"version": N, "presets": {...}}``) so
long-lived preset files survive framework upgrades: version-0 files (the
bare name→preset dict this store wrote before versioning) are migrated on
read, and settings keys a *newer* writer added that this build doesn't know
are dropped with a warning instead of crashing the load.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Optional

from .config import EQBand, StreamConfig

__all__ = ["PresetStore"]


def _logger():
    from ..utils.log import get_logger

    return get_logger("presets")

#: config fields excluded from presets (reference `:163-164`), plus the other
#: deployment-shape fields that arrived with the TPU build — including the
#: execution-strategy knobs (`ingest`, `conv_strategy`): a preset describes a
#: *sound*, not where/how it runs (a pair-ingest preset re-applied on an
#: f32 deployment would otherwise change the engine's input contract).
EXCLUDED_FIELDS = ("samplerate", "blocksize", "batch", "source_samplerate",
                   "ingest", "emit", "conv_strategy", "agc_link_group",
                   "output_rate")

#: on-disk schema version this build writes
FORMAT_VERSION = 1


class PresetStore:
    """Named preset snapshots with save/load/delete and JSON persistence."""

    def __init__(self, path: Optional[str] = None):
        self._presets: Dict[str, dict] = {}
        self.path = path
        if path and os.path.exists(path) and os.path.getsize(path) > 0:
            try:
                with open(path) as f:
                    raw = json.load(f)
                self._presets = self._migrate(raw)
            except (json.JSONDecodeError, OSError) as e:
                # corrupt store: start empty rather than refuse to boot
                _logger().warning("Preset store %s unreadable (%s); starting empty", path, e)
                self._presets = {}

    @staticmethod
    def _migrate(raw: dict) -> Dict[str, dict]:
        """Normalize any schema generation to the in-memory name→preset map.

        * version-0 (pre-versioning): the file IS the preset map;
        * version-1: ``{"version": 1, "presets": {...}}``;
        * future versions: load what we understand, warn once.
        """
        if not isinstance(raw, dict):
            _logger().warning("Preset store has non-dict root; starting empty")
            return {}
        if "version" not in raw:
            return raw  # legacy flat map (version 0)
        ver = raw.get("version")
        if not isinstance(ver, int) or ver > FORMAT_VERSION:
            _logger().warning(
                "Preset store written by a newer schema (version %r > %d); "
                "loading best-effort", ver, FORMAT_VERSION)
        presets = raw.get("presets", {})
        return presets if isinstance(presets, dict) else {}

    # --- reference-compatible surface ---

    def save_preset(self, name: str, cfg: StreamConfig) -> None:
        if not name:
            raise ValueError("Please enter a preset name")
        settings = {
            k: v for k, v in cfg.to_dict().items() if k not in EXCLUDED_FIELDS
        }
        gains = [b.gain for b in cfg.eq_bands]
        self._presets[name] = {"gains": gains, "settings": settings}
        self._flush()

    def load_preset(self, name: str, base: StreamConfig) -> StreamConfig:
        """Apply a preset onto `base`, keeping its excluded (deployment)
        fields — mirrors `load_preset` → `apply_changes` (`:172-181`)."""
        if name not in self._presets:
            raise KeyError(f"unknown preset {name!r}")
        p = self._presets[name]
        settings = dict(p["settings"])
        for k in EXCLUDED_FIELDS:
            settings.pop(k, None)
        # forward compatibility: a newer writer may have stored settings
        # fields this build doesn't have — drop them (with a warning) rather
        # than crash StreamConfig.from_dict
        known = {f.name for f in dataclasses.fields(StreamConfig)}
        unknown = [k for k in settings if k not in known]
        for k in unknown:
            settings.pop(k)
        if unknown:
            _logger().warning(
                "Preset %r: dropping settings unknown to this build: %s",
                name, sorted(unknown))
        saved_bands = settings.pop(
            "eq_bands", [dataclasses.asdict(x) for x in base.eq_bands])
        gains = list(p["gains"])
        if len(saved_bands) != len(gains):
            # the band STRUCTURE must never shrink to the gain count (a
            # missing gain is not a missing band): bands without a saved
            # gain keep their own; extra gains are ignored
            _logger().warning(
                "Preset %r: %d gains for %d EQ bands; bands without a "
                "gain keep their saved one, extra gains are ignored",
                name, len(gains), len(saved_bands))
        band_known = {f.name for f in dataclasses.fields(EQBand)}

        def _mk_band(b):
            if not isinstance(b, dict):
                return b
            extra = sorted(set(b) - band_known)
            if extra:  # per-band forward compatibility (same contract as
                # the top-level settings filter above)
                _logger().warning(
                    "Preset %r: dropping EQ band fields unknown to this "
                    "build: %s", name, extra)
            return EQBand(**{k: v for k, v in b.items() if k in band_known})

        bands = tuple(
            dataclasses.replace(_mk_band(b), gain=gains[i])
            if i < len(gains) else _mk_band(b)
            for i, b in enumerate(saved_bands)
        )
        merged = {**base.to_dict(), **settings}
        for k in EXCLUDED_FIELDS:
            merged[k] = getattr(base, k)
        merged["eq_bands"] = [dataclasses.asdict(b) for b in bands]
        return StreamConfig.from_dict(merged).validate()

    def delete_preset(self, name: str) -> None:
        self._presets.pop(name, None)
        self._flush()

    def get(self, name: str) -> dict:
        """Return a copy of the stored preset record ({"gains", "settings"})
        — the inspection surface the CLI's ``preset show`` uses."""
        if name not in self._presets:
            raise KeyError(f"unknown preset {name!r}")
        return json.loads(json.dumps(self._presets[name]))

    @property
    def names(self):
        return list(self._presets.keys())

    def __contains__(self, name: str) -> bool:
        return name in self._presets

    def _flush(self) -> None:
        if self.path:
            # atomic replace: a crash mid-dump must never leave a truncated
            # file (the constructor treats corrupt JSON as an empty store,
            # so an in-place write could silently destroy every preset)
            tmp = f"{self.path}.tmp"
            with open(tmp, "w") as f:
                json.dump({"version": FORMAT_VERSION, "presets": self._presets},
                          f, indent=2)
            os.replace(tmp, self.path)
