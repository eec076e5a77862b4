"""The port's multi-device layer against the JAX package's on the CPU: the
port's meshes of eight CPU shards (``make_mesh(8, device="cpu")``) against
the JAX package's ``make_mesh(8)`` over the eight virtual CPU devices of
``tests/conftest.py``, the same seeded inputs through both.

Every meshed output of the port must equal the port's unmeshed output bit for
bit (lanes are independent: a shard runs the group's step on its own rows),
and the JAX package's meshed output on the same inputs, bit for bit with the
JAX functions jitted as the engines run them, except where the unmeshed tests
already hold the port to a bound: a lane with a filter set to
``test_torch_batch_dsp.RESIDUE_FRAC`` (ROADMAP fault 3.2). Group and lane
counts divide no shard count, so padded lanes are stepped and dropped.

The CPU runs the kernels' plain versions, loops of small torch ops whose
cost grows with the shard count (each shard loops on its own rows), so the
DFPWM lanes here run few bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aukit_tpu.codecs import flac as jax_flac
from aukit_tpu.codecs.dfpwm import DfpwmState as JaxState
from aukit_tpu.kernels import dfpwm_pallas as jax_dkp
from aukit_tpu.kernels import flac_pallas as jax_kflac
from aukit_tpu.parallel import pipeline as jax_pipe
from aukit_tpu.stream import batch as jax_batch
from aukit_tpu.stream import batch_encode as jax_encode
from aukit_tpu.stream import fleet as jax_fleet
from aukit_tpu.stream.flac_fleet import FlacFleet as JaxFlacFleet
from aukit_tpu_torch import kernels
from aukit_tpu_torch.codecs import flac
from aukit_tpu_torch.codecs.dfpwm import DfpwmState
from aukit_tpu_torch.kernels.flac_cuda import lpc_restore_kernel, lpc_restore_sharded
from aukit_tpu_torch.parallel import pipeline
from aukit_tpu_torch.parallel.pipeline import make_mesh
from aukit_tpu_torch.stream import batch, batch_encode
from aukit_tpu_torch.stream.flac_fleet import FlacFleet
from aukit_tpu_torch.stream.fleet import Fleet
from tests import fixtures
from tests.test_flac_fleet import make_flac
from tests.test_torch_batch import assert_checkpoints_equal, assert_steps_equal, collect
from tests.test_torch_batch_dsp import assert_residue
from tests.test_torch_flac_fleet import assert_steps_equal as assert_flac_steps_equal
from tests.test_torch_flac_fleet import drive

SHARDS = 8


@pytest.fixture(scope="module")
def meshes():
    """(the port's CPU mesh, the JAX package's mesh), eight shards each."""
    return make_mesh(SHARDS, device="cpu"), jax_pipe.make_mesh(SHARDS)


def to_numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shape_rule(n):
    """The near-square (dp, sp) rule of the JAX package for 1-8 shards, and
    round-robin placement: more shards than devices share the one CPU."""
    got, want = make_mesh(n, device="cpu"), jax_pipe.make_mesh(n)
    assert got.devices.shape == want.devices.shape
    assert got.devices.size == n and got.axis_names == tuple(want.axis_names) == ("dp", "sp")
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_sharded_pipeline_step_matches_jax(meshes):
    """16 lanes x 96 bytes over eight shards: kernel (a)'s plain version on
    every shard, the batch peak one max over the shards; bit-equal to the
    JAX package's sharded step and to the port's unsharded
    ``decode_pipeline_scan(normalize_peak=0.9)``, state included."""
    mesh, jmesh = meshes
    fn, args = pipeline.sharded_pipeline_step(mesh, 16, 96)
    assert [a.shape for a in args[0]] == [(2, 96)] * SHARDS
    got = [torch.cat(part).numpy() for part in fn(*args)]
    jfn, jargs = jax_pipe.sharded_pipeline_step(jmesh, 16, 96)
    want = [np.asarray(x) for x in jfn(*jargs)]
    np.testing.assert_array_equal(torch.cat(args[0]).numpy(), np.asarray(jargs[0]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    out, st = pipeline.decode_pipeline_scan(torch.cat(args[0]), DfpwmState.zeros(16), 48000, 0.9)
    np.testing.assert_array_equal(got[0], out.numpy())
    for g, leaf in zip(got[1:], st.leaves()):
        np.testing.assert_array_equal(g, leaf.numpy())


def test_decode_pipeline_pallas_twin_matches_jax(monkeypatch):
    """The lane-major twin against the JAX ``decode_pipeline_scan`` (jitted)
    and against the JAX ``decode_pipeline_pallas`` with
    ``dfpwm_decode_grouped`` in interpret mode, in its [G, B, 32, 128]
    layout, on 16 lanes x 128 bytes from a random state."""
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (16, 128), dtype=np.uint8)
    leaves = [rng.integers(-128, 128, 16), rng.integers(8, 1024, 16), rng.integers(0, 2, 16),
              rng.integers(-128, 128, 16), rng.integers(-128, 128, 16)]
    leaves = [a.astype(np.int32) for a in leaves]
    out, st = pipeline.decode_pipeline_pallas(torch.tensor(data), DfpwmState(
        *map(torch.tensor, leaves)), 32000)
    scan = jax.jit(jax_pipe.decode_pipeline_scan, static_argnums=(2, 3))
    want, wst = scan(jnp.asarray(data), JaxState(*map(jnp.asarray, leaves)), 32000, None)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    for g, w in zip(st.leaves(), jax.tree_util.tree_leaves(wst)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    grouped = jax_dkp.dfpwm_decode_grouped
    monkeypatch.setattr(jax_dkp, "dfpwm_decode_grouped",
                        lambda b, s, n=None, interpret=False: grouped(b, s, n, True))
    bytes_gm, _ = jax_dkp.lanes_to_groups(data, jax_dkp.TIME_TILE)
    out_gm, st_gm = jax.jit(jax_pipe.decode_pipeline_pallas, static_argnums=(2,))(
        bytes_gm, jax_dkp.state_to_groups(JaxState(*map(jnp.asarray, leaves))), 32000)
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_dkp.groups_to_lanes(out_gm, 16, out.shape[1])))
    for g, w in zip(st.leaves(), jax.tree_util.tree_leaves(jax_dkp.state_from_groups(st_gm, 16))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the decode engine ------------------------------------------------------------------

# group sizes 3 / 2 / 1 / 1 / 1 divide no shard count: DFPWM at 8 kHz (kernel
# (a) and dsp_chain), µ-law, PCM16, IMA and MS ADPCM (kernels (d), (e))
MIXED = (("dfpwm", 8000),) * 3 + (("ulaw", 8000),) * 2 + (("pcm16", 24000),) \
    + (("ima", 8000, 1, 256),) + (("msadpcm", 8000, 1, 256),)


def mixed_feeds(rng):
    feeds = [rng.integers(0, 256, 1500, dtype=np.uint8).tobytes() for _ in range(3)]
    feeds += [rng.integers(0, 256, 8000 * 2, dtype=np.uint8).tobytes() for _ in range(2)]
    feeds += [(np.sin(np.arange(24000 * 2) / 9.0) * 20000).astype("<i2").tobytes()]
    feeds += [rng.integers(0, 256, 256 * 40, dtype=np.uint8).tobytes() for _ in range(2)]
    return feeds


def engine_runs(make, feeds, volumes=(), filters=(), normalize=None, port_meshes=(None,),
                jax_mesh=None):
    """The port's engines (one a mesh of ``port_meshes``) and the JAX engine
    over ``jax_mesh``, fed the same bytes; each run's steps and final
    checkpoints."""
    runs = []
    engines = [make(batch, m, {"device": "cpu"}) for m in port_meshes]
    engines.append(make(jax_batch, jax_mesh, {}))
    for eng in engines:
        for lane, vol, ramp in volumes:
            eng.set_volume(lane, vol, ramp=ramp)
        for lane, kind, cutoff in filters:
            eng.set_filter(lane, kind, cutoff)
        for lane, data in enumerate(feeds):
            eng.feed(lane, data)
            eng.feed(lane, None)
        if normalize is not None:
            eng.normalize(normalize)
        runs.append((collect(eng), [eng.checkpoint(i) for i in range(len(feeds))]))
    return runs


def test_mixed_engine_sharded_matches_jax(meshes):
    """The twin of the JAX package's mixed fleets over a mesh
    (tests/test_batch.py:705, :816): groups of 3/2/1/1/1 lanes over eight
    shards, a volume ramp; windows, masks, positions and checkpoints."""
    mesh, jmesh = meshes
    specs = [batch.LaneSpec(*s) for s in MIXED]
    jspecs = [jax_batch.LaneSpec(*s) for s in MIXED]
    kernels.reset_counts()

    def make(mod, m, kw):
        return mod.BatchStreamEngine(specs if mod is batch else jspecs, m, **kw)

    (sharded, ck_s), (plain, ck_p), (jax_run, ck_j) = engine_runs(
        make, mixed_feeds(np.random.default_rng(5)), volumes=((1, 0.5, True), (6, 1.5, False)),
        port_meshes=(mesh, None), jax_mesh=jmesh)
    assert len(sharded) >= 2
    assert_steps_equal(sharded, plain)
    assert_steps_equal(sharded, jax_run)
    for s, p, j in zip(ck_s, ck_p, ck_j):
        assert_checkpoints_equal(s, p)
        assert_checkpoints_equal(s, j)
    # the one-lane IMA and MS ADPCM groups step one shard each, the other
    # seven hold padding only and launch nothing
    assert kernels.ima_decode_ref.calls == kernels.msadpcm_decode_ref.calls > 0


def test_fused_dfpwm_engine_sharded_with_checkpoint_in_last_shard(meshes):
    """11 identity-rate DFPWM lanes (kernel (b)) over eight shards of two
    lanes, the last shard half padding, a volume ramp on lanes of the first
    and the last shard; lane 10, in the last shard, is checkpointed after
    the first step and restored into a fresh engine of each kind (the
    port's unsharded, the JAX package's sharded) whose run of that lane
    equals the sharded run."""
    mesh, jmesh = meshes
    rng = np.random.default_rng(9)
    lanes, chunk = 11, 64
    feeds = [rng.integers(0, 256, chunk * 3 - 7 * (i % 2), dtype=np.uint8).tobytes()
             for i in range(lanes)]
    engines = [batch.BatchDfpwmDecoder(lanes, 48000, chunk, mesh, device="cpu"),
               batch.BatchDfpwmDecoder(lanes, 48000, chunk, device="cpu"),
               jax_batch.BatchDfpwmDecoder(lanes, 48000, chunk, jmesh)]
    runs = []
    for eng in engines:
        eng.set_volume(1, 0.5, ramp=True)
        eng.set_volume(10, 1.25, ramp=True)
        for lane, data in enumerate(feeds):
            eng.feed(lane, data)
            eng.feed(lane, None)
        first = collect_one(eng)
        ckpt = eng.checkpoint(10)
        runs.append(([first, *collect(eng)], ckpt, [eng.checkpoint(i) for i in range(lanes)]))
    (s_steps, s_ck, s_end), (p_steps, p_ck, p_end), (j_steps, j_ck, j_end) = runs
    assert_steps_equal(s_steps, p_steps)
    assert_steps_equal(s_steps, j_steps)
    for s, p, j in zip([s_ck, *s_end], [p_ck, *p_end], [j_ck, *j_end]):
        assert_checkpoints_equal(s, p)
        assert_checkpoints_equal(s, j)
    tail = feeds[10][s_ck["byte_offset"] + len(s_ck["pending"]):]
    assert tail == b""  # the checkpoint holds the lane's unconsumed bytes as pending
    resumed = []
    for eng in (batch.BatchDfpwmDecoder(lanes, 48000, chunk, device="cpu"),
                jax_batch.BatchDfpwmDecoder(lanes, 48000, chunk, jmesh),
                batch.BatchDfpwmDecoder(lanes, 48000, chunk, mesh, device="cpu")):
        for lane in range(lanes):
            if lane != 10:
                eng.feed(lane, None)
        eng.restore(10, s_ck)
        resumed.append([to_numpy(r[0])[10] for r in iter(eng.step, None)])
    want = [w[10] for w, _m, _p in s_steps[1:]]
    for got in resumed:
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def collect_one(eng):
    r = eng.step()
    return to_numpy(r[0]), r[1].copy(), r[2].copy()


def test_dsp_stages_sharded_match_jax(meshes):
    """The twin of tests/test_batch_dsp.py:239: a lowpass, a highpass and a
    volume on three PCM16 lanes, then normalize(0.8), over eight shards.
    Sharded == unsharded bit for bit; against the JAX sharded engine the
    filtered lanes keep the unsharded tests' bound (fault 3.2), the rest
    bit-equal."""
    mesh, jmesh = meshes
    n = 48000
    feeds = [(np.sin(np.arange(n) / (7 + 4 * i)) * 20000).astype("<i2").tobytes()
             for i in range(3)]

    def make(mod, m, kw):
        return mod.BatchStreamEngine([mod.LaneSpec("pcm16", 48000)] * 3, m, windowed=True, **kw)

    (sharded, ck_s), (plain, ck_p), (jax_run, _ck_j) = engine_runs(
        make, feeds, volumes=((1, 0.7, False),),
        filters=((0, "lowpass", 2000), (2, "highpass", 500)), normalize=0.8,
        port_meshes=(mesh, None), jax_mesh=jmesh)
    assert_steps_equal(sharded, plain)
    for s, p in zip(ck_s, ck_p):
        assert_checkpoints_equal(s, p)
    assert len(sharded) == len(jax_run) > 0
    for (w, m, pos), (jw, jm, jpos) in zip(sharded, jax_run):
        np.testing.assert_array_equal(m, jm)
        np.testing.assert_array_equal(pos, jpos)
        np.testing.assert_array_equal(w[1], jw[1])
        for lane in (0, 2):
            assert_residue(w[lane], jw[lane])


# -- the encode engine ------------------------------------------------------------------

def encode_drain(enc):
    outs = [bytearray() for _ in range(enc.lanes)]
    while (r := enc.step()) is not None:
        host = to_numpy(r[0])
        for i in np.nonzero(r[2])[0]:
            outs[i].extend(host[i, : r[1][i]].tobytes())
    return [bytes(o) for o in outs]


def test_encode_engine_sharded_matches_jax(meshes):
    """The twin of tests/test_batch_encode.py:173 (mixed DFPWM + PCM16 groups
    whose lane counts divide no shard count), host-fed, 4800 samples a lane,
    with an encoder checkpoint of the last lane restored across packages."""
    mesh, jmesh = meshes
    n = 4800
    sigs = [(np.sin(np.arange(n) / (5 + 3 * i)) * 0.8).astype(np.float32) for i in range(3)]
    codecs = ("dfpwm", "dfpwm", "pcm16")
    outs = []
    for mod, m, kw in ((batch_encode, mesh, {"device": "cpu"}), (batch_encode, None,
                       {"device": "cpu"}), (jax_encode, jmesh, {})):
        enc = mod.BatchEncodeEngine([mod.EncodeSpec(c) for c in codecs], n, m, **kw)
        for i, s in enumerate(sigs):
            enc.feed(i, s)
            enc.feed(i, None)
        outs.append((encode_drain(enc), enc.checkpoint(1)))
    assert outs[0][0] == outs[1][0] == outs[2][0]
    assert outs[0][1]["codec_state"] == outs[2][1]["codec_state"] != [0, 0, 0]


def test_transcode_of_sharded_engines_matches_jax(meshes):
    """``transcode_fleet`` from a sharded decode engine into a sharded encode
    engine: each window arrives gathered on the first shard's device and is
    split into the encode shards there. Three 8 kHz PCM16 lanes into DFPWM,
    PCM8 and PCM16, with a volume on the encoder."""
    mesh, jmesh = meshes
    feeds = [(np.sin(np.arange(8000) / (6.0 + i)) * (9000 + 3000 * i)).astype("<i2").tobytes()
             for i in range(3)]
    codecs = ("dfpwm", "pcm8", "pcm16")
    outs = []
    for dmod, emod, m, kw in ((batch, batch_encode, mesh, {"device": "cpu"}),
                              (batch, batch_encode, None, {"device": "cpu"}),
                              (jax_batch, jax_encode, jmesh, {})):
        src = dmod.BatchStreamEngine([dmod.LaneSpec("pcm16", 8000)] * 3, m, windowed=True, **kw)
        for lane, data in enumerate(feeds):
            src.feed(lane, data)
            src.feed(lane, None)
        enc = emod.BatchEncodeEngine([emod.EncodeSpec(c) for c in codecs], 48000, m, **kw)
        enc.set_volume(1, 0.75)
        outs.append((batch_encode if emod is batch_encode else jax_encode).transcode_fleet(
            src, enc))
    assert outs[0] == outs[1] == outs[2]
    assert all(len(o) > 0 for o in outs[0])


# -- FLAC: the sharded restore, restore_flat, FlacFleet ------------------------------------

def flac_batch(seed: int = 3):
    """A parsed FLAC batch (stereo mid/side, LPC up to order 12; 13 subframes)."""
    data = make_flac(44100, 6, n=576, channels=2, chan_asgn=10, seed=seed)
    sample_rate, channels, depth, _n, _meta, pos = flac.parse_flac_header(data)
    return flac.parse_all_frames(data, pos, channels, depth)


def test_lpc_restore_sharded_matches_jax(meshes):
    """``lpc_restore_sharded`` over eight shards (rows padded to a multiple)
    against the JAX package's over its mesh and the port's unsharded kernel
    wrapper, on a parsed FLAC batch."""
    mesh, jmesh = meshes
    _fm, sub, coefs, values = flac_batch()
    S, T = len(sub["order"]), int(sub["block"].max())
    assert S % SHARDS
    vals = np.zeros((S, T), np.int32)
    vals[np.arange(T)[None, :] < sub["block"][:, None]] = values
    args = [vals] + [sub[k].astype(np.int32) for k in ("order", "shift", "block")]
    args.append(coefs.astype(np.int32))
    kernels.reset_counts()
    got = lpc_restore_sharded(*args, mesh)
    per_shard = -(-S // SHARDS)  # shards of padding only launch nothing
    assert got.dtype == torch.int64 and kernels.lpc_restore_ref.calls == -(-S // per_shard)
    want = np.asarray(jax_kflac.lpc_restore_sharded(*args, jmesh))
    np.testing.assert_array_equal(got.numpy(), want)
    plain = lpc_restore_kernel(*map(torch.from_numpy, args[:4]), torch.from_numpy(args[4]))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


@pytest.mark.parametrize("device", [None, True, False])
def test_restore_flat_mesh_routes(meshes, monkeypatch, device):
    """``restore_flat(mesh=)``: the sharded restore for ``device`` None or
    True, the host restore for an explicit ``device=False`` (it wins over the
    mesh, as in the JAX package, tests/test_flac_fleet.py:647); every route
    equals the JAX package's meshed restore_flat."""
    mesh, jmesh = meshes
    _fm, sub, coefs, values = flac_batch(5)
    kernels.reset_counts()
    got = flac.restore_flat(sub, coefs, values.copy(), 16, device, mesh)
    assert (kernels.lpc_restore_ref.calls > 0) == (device is not False)
    if device is False:
        monkeypatch.setattr(jax_kflac, "lpc_restore_sharded",
                            lambda *a, **k: pytest.fail("sharded restore with device=False"))
    want = jax_flac.restore_flat(sub, coefs, values.copy(), 16, device, jmesh)
    np.testing.assert_array_equal(got, want)


def test_flac_fleet_host_route_sharded_matches_jax(meshes):
    """FlacFleet's host route with a mesh: the restore batch of every step
    splits over the shards (kernel (g)'s plain version a shard), the rest on
    the host; every step, checkpoint and metric equals the unsharded port
    fleet and the JAX fleet over its mesh."""
    mesh, jmesh = meshes
    datas = [make_flac(44100, 3, channels=2, chan_asgn=10, seed=21 + i) for i in range(3)]
    datas.append(make_flac(48000, 3, seed=24, depth=24))
    runs = []
    kernels.reset_counts()
    for fleet in (FlacFleet(len(datas), mesh=mesh, device="cpu"),
                  FlacFleet(len(datas), device="cpu"), JaxFlacFleet(len(datas), mesh=jmesh)):
        runs.append((drive(fleet, datas, chunk=5000), fleet))
    assert kernels.lpc_restore_ref.calls > 0
    (sharded, sf), (plain, pf), (jax_run, jf) = runs
    assert_flac_steps_equal(sharded, plain)
    assert_flac_steps_equal(sharded, jax_run)
    for lane in range(len(datas)):
        for other in (pf, jf):
            a, b = sf.checkpoint(lane), other.checkpoint(lane)
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("mode", ["linear", "cubic"])
def test_flac_fleet_device_route_sharded_matches_jax(meshes, mode):
    """The twin of tests/test_flac_fleet.py:815: the device-resident route
    with a mesh (the restore rows padded to whole frames on every shard,
    the block-lowpass rows to a multiple of the shards; kernels (g) and (h)
    a shard) equals the unsharded port route bit for bit. Against the JAX
    route over its mesh (its Pallas kernels in interpret mode) the windows
    are held to fault 3.9's 2e-6, the bound of the unsharded tests: the JAX
    FLAC device routes differ from each other, and its meshed route differs
    from its unmeshed one at 44.1 kHz in linear mode (4 samples by 1.2e-7;
    the port equals the unmeshed one there and the meshed one in cubic)."""
    mesh, jmesh = meshes
    datas = [make_flac(48000, 4, seed=62 + i) for i in range(3)]
    datas.append(make_flac(44100, 4, seed=65, channels=2, chan_asgn=9))
    runs = []
    kernels.reset_counts()
    for fleet in (FlacFleet(len(datas), True, mesh, True, interpolation=mode, device="cpu"),
                  FlacFleet(len(datas), True, None, True, interpolation=mode, device="cpu"),
                  JaxFlacFleet(len(datas), True, jmesh, True, interpolation=mode)):
        if isinstance(fleet, JaxFlacFleet):
            fleet._block_iir = "interpret"
        runs.append(drive(fleet, datas, chunk=6000))
    assert kernels.lpc_restore_ref.calls > 0 and kernels.iir_zero_ref.calls > 0
    assert_flac_steps_equal(runs[0], runs[1])
    assert len(runs[0]) == len(runs[2])
    for g, w in zip(runs[0], runs[2]):
        assert (g is None) == (w is None)
        if w is not None:
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_array_equal(g[2], w[2])
            np.testing.assert_allclose(g[0], w[0], rtol=0, atol=2e-6)


def test_fleet_sharded_matches_jax(meshes):
    """The Fleet facade over a mesh (``__graft_entry__.py:291-317``): FLAC, a
    DFPWM lane and a PCM16 WAV behind one step, the merge on the first
    shard's device; equal to the unsharded port Fleet and the JAX Fleet over
    its mesh."""
    mesh, jmesh = meshes
    rng = np.random.default_rng(0)
    wav = fixtures.wav_pcm((np.sin(np.arange(24000) / 9.0) * 15000).astype("<i2")[None, :],
                           24000, 16)
    dfp = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    flac_data = make_flac(44100, 4, seed=31, channels=2, chan_asgn=10)
    runs = []
    for mod, m, kw in ((batch, mesh, {"device": "cpu"}), (batch, None, {"device": "cpu"}),
                       (jax_batch, jmesh, {})):
        sources = [flac_data, (mod.LaneSpec("dfpwm", 8000), dfp), wav]
        fleet_cls = Fleet if mod is batch else jax_fleet.Fleet
        fleet = fleet_cls(sources, mesh=m, **kw)
        steps = []
        while not fleet.done:
            r = fleet.step()
            if r is not None:
                steps.append((to_numpy(r[0]), np.asarray(r[1]), np.asarray(r[2])))
        runs.append(steps)
    assert len(runs[0]) > 0
    assert_steps_equal(runs[0], runs[1])
    assert_steps_equal(runs[0], runs[2])


def test_mesh_arguments():
    """A foreign mesh raises TypeError naming make_mesh (the JAX package
    raises AttributeError there: ROADMAP fault 3.8); a device that is not
    the mesh's raises ValueError; the mesh's first device is the engine's."""
    mesh = make_mesh(2, device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        pipeline.sharded_pipeline_step(object(), 4, 8)
    with pytest.raises(TypeError, match="make_mesh"):
        lpc_restore_sharded(np.zeros((1, 4), np.int32), *([np.zeros(1, np.int32)] * 3),
                            np.zeros((1, 4), np.int32), jax_pipe.make_mesh(2))
    with pytest.raises(ValueError, match="conflicts"):
        batch.BatchDfpwmDecoder(2, mesh=mesh)
    with pytest.raises(ValueError):
        pipeline.sharded_pipeline_step(mesh, 3, 8)
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")
    eng = batch.BatchDfpwmDecoder(3, mesh=mesh, device="cpu")
    assert eng.device == torch.device("cpu") and eng.mesh is mesh
    assert [(sh.lo, sh.hi) for sh in eng.groups[0].shards] == [(0, 2), (2, 4)]
    assert batch.BatchDfpwmDecoder(1, mesh=make_mesh(4, device="cpu"),
                                   device="cpu").groups[0].shards[0].hi == 1
