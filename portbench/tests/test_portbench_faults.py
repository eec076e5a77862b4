"""The check against a broken program: each cell's run, rehearsed on the CPU
with the timed path broken underneath, comes out not correct, once for each
fault the cell can have (on one chip there is no exchange between chips to
leave out):

- ``state``: a step that hands its state back unchanged (every carried
  tensor of every group as it was before the step);
- ``half``: half of the batch left out (the windows of the second half of
  the lanes or stations never filled);
- ``altered``: an answer altered where it is produced (one sample of every
  window moved).

and, in the speakers' cells, ``start``: an engine whose lanes begin from a
state other than DFPWM's zero state (every lane's charge at 3): the check
decodes the first tick from the zero state, so the first samples differ.
"""

import copy

import pytest

from conftest import rehearse

CELLS = ["dfpwm_speakers.uniform_48k", "dfpwm_speakers.mixed_rates",
         "dfpwm_speakers.lowpass", "radio_fleet.live_mixed"]
FAULTS = ["state", "half", "altered"]


def _carried(eng):
    return [(sh, {k: copy.copy(getattr(sh, k)) for k in ("state", "fir", "filt_y", "filt_x")})
            for g in eng.groups for sh in g.shards]


def _broken(fault, step):
    def wrapped(self):
        before = _carried(self.engine if hasattr(self, "engine") else self) \
            if fault == "state" else None
        r = step(self)
        if r is None:
            return r
        if fault == "state":
            for sh, saved in before:
                for k, v in saved.items():
                    setattr(sh, k, v)
            return r
        w = r[0].clone()
        if fault == "half":
            w[w.shape[0] // 2:] = 0
        else:
            w[:, 1000] = (w[:, 1000].to(int) + 77).to(w.dtype)
        return (w, *r[1:])
    return wrapped


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault, monkeypatch):
    from aukit_tpu_torch.stream.batch import BatchStreamEngine
    from aukit_tpu_torch.stream.fleet import Fleet

    cls = Fleet if workload.startswith("radio") and fault != "state" else BatchStreamEngine
    monkeypatch.setattr(cls, "step", _broken(fault, cls.step))
    r = rehearse(workload, seconds=3.0 if workload.startswith("radio") else 0.0)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("workload", CELLS[:3])
def test_wrong_start_state_is_not_correct(workload, monkeypatch):
    from aukit_tpu_torch.codecs.dfpwm import DfpwmState
    from aukit_tpu_torch.stream import batch

    def started_wrong(spec, lanes, device="cpu"):
        st = DfpwmState.zeros(lanes, device)
        st.charge += 3
        return st

    monkeypatch.setattr(batch, "init_state", started_wrong)
    r = rehearse(workload)
    assert not r["correct"], r["checks"]
