"""The plain reference's parts against what they must give: the FLAC
decoder against the signal the writer coded, the float32 multiply-add
against exact arithmetic, the DFPWM decoder's state chain against one long
decode."""

import numpy as np
import torch

from portbench.inputs.stations import FlacTrack, ImaTrack, flac_signal
from portbench.reference import dfpwm, dsp, flac, ima


def test_flac_decoder_gives_back_the_coded_signal():
    rng = np.random.default_rng(3)
    track = FlacTrack(rng, 3.0)
    rng = np.random.default_rng(3)
    sigs = flac_signal(rng, track.frames)
    stream = track.stream(2)
    *_info, first = flac.streaminfo(stream)
    offs = track.offsets[2:] - track.offsets[2] + first
    (got,) = flac.decode_frames([(stream, offs)])
    assert np.array_equal(got, sigs[2:])


def test_flac_writer_codes_by_the_minus_5_rules():
    track = FlacTrack(np.random.default_rng(6), 8.0)
    stream = track.stream(0)
    *_info, first = flac.streaminfo(stream)
    lays = [flac._frame_layout(stream, int(o) + first, 16) for o in track.offsets[:-1]]
    assert {(lay["order"], lay["precision"], lay["pbits"]) for lay in lays} == {(8, 12, 4)}
    orders = [lay["porder"] for lay in lays]
    assert max(orders) <= 5 and len(set(orders)) >= 3
    assert all(0 <= lay["shift"] <= 15 for lay in lays)


def test_ima_decoder_keeps_16_bits_and_low_index_bits():
    rng = np.random.default_rng(4)
    t = ImaTrack(rng, 0.2)
    blocks = np.frombuffer(t.blocks, np.uint8).reshape(-1, 256)
    out = ima.decode_blocks(blocks)
    assert out.shape == (len(blocks), 504)
    assert out.min() >= -32768 and out.max() <= 32767


def test_fma_rounds_once():
    x = torch.tensor([1.0 + 2 ** -23, 3.0], dtype=torch.float32)
    y = torch.tensor([1.0 - 2 ** -23, 1 / 3], dtype=torch.float32)
    z = torch.tensor([-1.0, -1.0], dtype=torch.float32)
    exact = (x.double() * y.double() + z.double()).float()
    assert torch.equal(dsp.fma(x, y, z), exact)


def test_dfpwm_decode_in_two_parts_equals_one():
    data = torch.from_numpy(np.random.default_rng(5).integers(0, 256, (3, 64), dtype=np.uint8))
    zero = torch.zeros((5, 3), dtype=torch.int32)
    whole, st = dfpwm.decode(data, zero)
    a, mid = dfpwm.decode(data[:, :40].contiguous(), zero)
    b, st2 = dfpwm.decode(data[:, 40:].contiguous(), mid)
    assert torch.equal(whole, torch.cat([a, b], dim=1)) and torch.equal(st, st2)
