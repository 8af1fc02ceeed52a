"""Codestream structure unit tests (reference codestream/parser_test.go,
parser_advanced_test.go, parser_codestream_test.go, types_test.go).

Marker writer/parser roundtrips live in test_j2k_markers.py and hostile
inputs in test_corruption_fuzz.py; this file pins tile geometry, the
COD/COC/QCD/QCC precedence chain, and tile-part merge semantics.
"""

import struct

import pytest

from go_dicom_codec_jax.codestream.j2k import (CocInfo, CodInfo, Codestream,
                                               PocEntry, QcdInfo, SizInfo,
                                               TileInfo, _overlay_coc,
                                               parse_codestream, write_cod,
                                               write_com, write_qcd,
                                               write_rgn, write_siz,
                                               write_tile_part)
from go_dicom_codec_jax.errors import CorruptStreamError

SOC = b"\xff\x4f"
EOC = b"\xff\xd9"


def _siz(w=64, h=48, tw=32, th=48, ncomp=1):
    return SizInfo(xsiz=w, ysiz=h, xtsiz=tw, ytsiz=th,
                   components=[(8, False, 1, 1)] * ncomp)


def _main_header(siz=None, cod=None, qcd=None):
    siz = siz or _siz()
    cod = cod or CodInfo(num_levels=2)
    qcd = qcd or QcdInfo(style=0, guard_bits=2, exponents=[9] * 7)
    return SOC + write_siz(siz) + write_cod(cod) + write_qcd(qcd)


# ---- SIZ tile geometry (B.3) ------------------------------------------------

def test_num_tiles_exact_division():
    assert _siz(64, 48, 32, 48).num_tiles == (2, 1)


def test_num_tiles_rounds_up():
    assert _siz(65, 49, 32, 48).num_tiles == (3, 2)


def test_num_tiles_with_tile_offset():
    s = SizInfo(xsiz=64, ysiz=64, xtsiz=32, ytsiz=32, xtosiz=16, ytosiz=16,
                components=[(8, False, 1, 1)])
    assert s.num_tiles == (2, 2)


def test_tile_rect_clamps_to_image():
    s = _siz(65, 48, 32, 48)
    assert s.tile_rect(0, 0) == (0, 0, 32, 48)
    assert s.tile_rect(2, 0) == (64, 0, 65, 48)  # 1-px remainder tile


def test_tile_rect_respects_image_offset():
    s = SizInfo(xsiz=64, ysiz=64, xosiz=10, yosiz=5, xtsiz=32, ytsiz=32,
                components=[(8, False, 1, 1)])
    assert s.tile_rect(0, 0) == (10, 5, 32, 32)


# ---- precedence chain (types.go:200-280 equivalents) ------------------------

def _cs():
    main_cod = CodInfo(num_levels=5, num_layers=3, mct=1, progression=2)
    return Codestream(siz=_siz(), cod=main_cod, qcd=QcdInfo(exponents=[9]))


def test_cod_for_defaults_to_main():
    cs = _cs()
    assert cs.cod_for(0) is cs.cod


def test_cod_for_main_coc_overlays_spcod_only():
    cs = _cs()
    cs.coc[1] = CocInfo(comp=1, num_levels=2, cb_width=32, cb_height=16)
    eff = cs.cod_for(1)
    assert eff.num_levels == 2 and eff.cb_width == 32
    # SGcod half (progression/layers/MCT) stays with COD
    assert eff.num_layers == 3 and eff.mct == 1 and eff.progression == 2
    # other components unaffected
    assert cs.cod_for(0).num_levels == 5


def test_cod_for_tile_cod_beats_main_coc():
    cs = _cs()
    cs.coc[0] = CocInfo(comp=0, num_levels=2)
    tile = TileInfo(index=0, cod=CodInfo(num_levels=4))
    assert cs.cod_for(0, tile).num_levels == 4


def test_cod_for_tile_coc_wins_over_everything():
    cs = _cs()
    cs.coc[0] = CocInfo(comp=0, num_levels=2)
    tile = TileInfo(index=0, cod=CodInfo(num_levels=4, num_layers=7))
    tile.coc[0] = CocInfo(comp=0, num_levels=1)
    eff = cs.cod_for(0, tile)
    assert eff.num_levels == 1
    assert eff.num_layers == 7  # overlays the TILE's COD, not main


def test_qcd_for_chain():
    cs = _cs()
    cs.qcc[1] = QcdInfo(style=1, steps=[(10, 0)])
    tile = TileInfo(index=0, qcd=QcdInfo(exponents=[8]))
    tile.qcc[1] = QcdInfo(style=2, steps=[(11, 5)])
    assert cs.qcd_for(0) is cs.qcd
    assert cs.qcd_for(1).style == 1            # main QCC
    assert cs.qcd_for(0, tile).exponents == [8]  # tile QCD
    assert cs.qcd_for(1, tile).style == 2      # tile QCC wins


def test_poc_for_tile_replaces_main():
    cs = _cs()
    cs.poc = [PocEntry(0, 0, 1, 6, 1, 0)]
    tile = TileInfo(index=0, poc=[PocEntry(0, 0, 2, 3, 1, 4)])
    assert cs.poc_for() == cs.poc
    assert cs.poc_for(tile)[0].prog == 4
    assert cs.poc_for(TileInfo(index=1)) == cs.poc  # empty tile POC falls back


def test_overlay_coc_preserves_sgcod():
    base = CodInfo(progression=3, num_layers=9, mct=1, num_levels=5,
                   use_sop=True)
    eff = _overlay_coc(base, CocInfo(comp=0, num_levels=2, transform=0))
    assert (eff.progression, eff.num_layers, eff.mct) == (3, 9, 1)
    assert eff.num_levels == 2 and eff.transform == 0


def test_precinct_exp_defaults():
    cod = CodInfo(precinct_exps=[(4, 4), (5, 5)])
    assert cod.precinct_exp(0) == (4, 4)
    assert cod.precinct_exp(7) == (15, 15)  # past the list → maximal
    assert CodInfo().precinct_exp(0) == (15, 15)


def test_qcd_num_bands_by_style():
    assert QcdInfo(style=0, exponents=[9] * 7).num_bands_encoded() == 7
    assert QcdInfo(style=2, steps=[(9, 0)] * 4).num_bands_encoded() == 4


# ---- tile-part merge (parser.go mergeTilePart) ------------------------------

def test_tile_parts_merge_in_tpsot_order():
    """Out-of-order TPsot parts concatenate by TPsot, not stream order."""
    stream = (_main_header()
              + write_tile_part(0, b"BBB", tpsot=1, tnsot=2)
              + write_tile_part(0, b"AAA", tpsot=0, tnsot=2)
              + EOC)
    cs = parse_codestream(stream)
    assert cs.tiles[0].data == b"AAABBB"


def test_two_tiles_parse_independently():
    stream = (_main_header()
              + write_tile_part(0, b"\x01\x02")
              + write_tile_part(1, b"\x03")
              + EOC)
    cs = parse_codestream(stream)
    assert set(cs.tiles) == {0, 1}
    assert cs.tiles[1].data == b"\x03"


def test_tile_part_psot_zero_runs_to_end():
    """Psot=0 is legal in the last tile-part: body extends to EOC."""
    sot = struct.pack(">HHHIBB", 0xFF90, 10, 0, 0, 0, 1)
    stream = _main_header() + sot + b"\xff\x93" + b"XYZ"
    cs = parse_codestream(stream)
    assert cs.tiles[0].data.startswith(b"XYZ")


def test_per_tile_cod_captured():
    tile_seg = write_cod(CodInfo(num_levels=1))
    sot = struct.pack(">HHHIBB", 0xFF90, 10, 0,
                      12 + len(tile_seg) + 2 + 2, 0, 1)
    stream = _main_header() + sot + tile_seg + b"\xff\x93" + b"\x00\x00" + EOC
    cs = parse_codestream(stream)
    assert cs.tiles[0].cod.num_levels == 1
    assert cs.cod_for(0, cs.tiles[0]).num_levels == 1


def test_com_and_rgn_captured():
    stream = (SOC + write_siz(_siz()) + write_com(b"hello")
              + write_rgn(0, 7, 1, style=0)
              + write_cod(CodInfo()) + write_qcd(QcdInfo(exponents=[9]))
              + EOC)
    cs = parse_codestream(stream)
    assert cs.comments == [b"hello"]
    assert cs.rgn_shifts == {0: 7} and cs.rgn_styles == {0: 0}


def test_missing_headers_rejected():
    with pytest.raises(CorruptStreamError):
        parse_codestream(SOC + write_siz(_siz()) + EOC)  # no COD/QCD
    with pytest.raises(CorruptStreamError):
        parse_codestream(b"\x00\x00\x00\x00")  # no SOC


def test_coc_before_siz_rejected():
    from go_dicom_codec_jax.codestream.j2k import write_coc
    stream = SOC + write_coc(CocInfo(comp=0), 1)
    with pytest.raises(CorruptStreamError):
        parse_codestream(stream)


def test_truncated_segment_rejected():
    good = _main_header() + EOC
    with pytest.raises(CorruptStreamError):
        parse_codestream(good[: len(good) - 6])
