"""Every public J2KEncodeParams field must flow through the registry
Parameters bag (three probes this round caught keys being silently
dropped: layer_rates, layer_budget_strategy, mct). This audit encodes
a sentinel for each field and asserts the adapter maps it."""

import dataclasses

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.j2k_adapters import _params_from
from go_dicom_codec_jax.codecs.jpeg2000 import J2KEncodeParams
from go_dicom_codec_jax.params import Parameters

# fields that intentionally do NOT travel through the Parameters bag
EXEMPT = {
    "lossless",   # chosen by the transfer-syntax UID
    "htj2k",      # chosen by the transfer-syntax UID
    "comment",    # encoder identity string
    "container",  # JP2/JPH file wrapper — DICOM transports RAW
                  # codestreams (PS3.5 A.4.4), so the adapters must
                  # never emit a boxed file; library/tools surface only
}

SENTINELS = {
    "num_levels": 3,
    "quality": 42,
    "cb_width": 32,
    "cb_height": 16,
    "progression": 2,
    "num_layers": 4,
    "tile_width": 128,
    "tile_height": 256,
    "cb_style": 0x08,
    "layer_rates": [9.0, 0],
    "target_ratio": 7.5,
    "append_lossless_layer": True,
    "roi_regions": ["sentinel-region"],
    "roi_style": "general",
    "roi_shift": 5,
    "mct": False,
    "mct_matrix": [[1.0]],
    "mct_inverse": [[1.0]],
    "mct_offsets": [0.5],
    "mct_bindings": ["sentinel-binding"],
    "block_encoder_factory": object(),
    "layer_budget_strategy": "EQUAL_RATE",
    "precincts": [(7, 7)],
    "precinct_width": 128,
    "precinct_height": 64,
    "guard_bits": 3,
    "custom_quant_steps": [0.25],
    "quant_step_scale": 2.0,
    "packed_headers": True,
    "use_sop": True,
    "use_eph": True,
    "plt_markers": True,
    "tlm_markers": True,
    "ht_refinement": True,
}


def test_every_param_field_is_mapped():
    fields = {f.name for f in dataclasses.fields(J2KEncodeParams)}
    missing_sentinels = fields - EXEMPT - set(SENTINELS)
    assert not missing_sentinels, (
        f"new J2KEncodeParams fields need an adapter mapping + a sentinel "
        f"here: {missing_sentinels}")

    params = Parameters(**SENTINELS)
    built = _params_from(params, lossless=True)
    for name, sentinel in SENTINELS.items():
        got = getattr(built, name)
        assert got == sentinel or got is sentinel, (
            f"Parameters key {name!r} did not flow through the adapter "
            f"(got {got!r}, want {sentinel!r})")
