"""The port's Checkpointer (``torchx_tpu_torch.parallel.checkpoint``) on the
CPU: the cases of tests/test_checkpoint.py ported to it, its read-only
reader, and its contract with the JAX package's readers on a port-written
directory (the supervisor's ``latest_checkpoint_step``, the eval gate's
``verify_checkpoint``, the digest recipe, the gang monitor's leases and
trace heartbeats, the shared settings values)."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from torchx_tpu import settings as jsettings
from torchx_tpu.apps import eval_main as jeval
from torchx_tpu.parallel import checkpoint as jckpt
from torchx_tpu.supervisor import api as jsup
from torchx_tpu.supervisor import gang as jgang
from torchx_tpu_torch import settings as tsettings
from torchx_tpu_torch.apps import eval_main as teval
from torchx_tpu_torch.obs import sinks
from torchx_tpu_torch.parallel import checkpoint as ckpt_mod
from torchx_tpu_torch.parallel.checkpoint import CheckpointMismatch, Checkpointer
from torchx_tpu_torch.supervisor import gang as tgang
from torchx_tpu_torch.util import session as tsession
from torch_threads import xdist_torch_threads  # noqa: F401


def _state(v=1.0):
    return {
        "w": torch.full((8,), float(v)),
        "b": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) * v,
        "step": torch.tensor(int(v), dtype=torch.int64),
    }


def _equal(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _corrupt_payload(directory, step):
    path = os.path.join(directory, str(step), ckpt_mod.PAYLOAD)
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) // 2)
        byte = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte[0] ^ 0xFF]))


def _listing(directory):
    """Every file under ``directory`` with its size and mtime."""
    out = {}
    for root, _, files in os.walk(directory):
        for name in files:
            p = os.path.join(root, name)
            st = os.stat(p)
            out[os.path.relpath(p, directory)] = (st.st_size, st.st_mtime_ns)
    return out


class TestCheckpointer:
    def test_save_restore_roundtrip(self, tmp_path):
        state = _state(3.0)
        ckpt = Checkpointer(str(tmp_path))
        assert ckpt.save(5, state)
        assert ckpt.latest_step() == 5
        assert _equal(ckpt.restore(5), state)
        # into live tensors: in place, same objects
        live = {k: torch.zeros_like(v) for k, v in state.items()}
        ptrs = {k: v.data_ptr() for k, v in live.items()}
        assert ckpt.restore(5, into=live) is live
        assert _equal(live, state)
        assert {k: v.data_ptr() for k, v in live.items()} == ptrs
        assert (tmp_path / "5" / ckpt_mod.PAYLOAD).is_file()
        ckpt.close()

    def test_restore_latest_empty(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        assert ckpt.restore_latest() == (None, None)
        ckpt.close()

    def test_max_to_keep(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
        for s in (1, 2, 3):
            ckpt.save(s, _state(s))
        assert ckpt.latest_step() == 3
        assert ckpt.all_steps() == [3, 2]
        doc = json.loads((tmp_path / "MANIFEST.json").read_text())
        assert set(doc["steps"]) == {"2", "3"} and doc["latest_step"] == 3
        ckpt.close()

    def test_async_save_overlaps_and_restores(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=True)
        assert ckpt.save(1, _state(1.0))
        ckpt.save(2, _state(2.0), force=True)
        ckpt.wait()
        assert ckpt.latest_step() == 2
        step, restored = ckpt.restore_latest()
        assert step == 2 and _equal(restored, _state(2.0))
        ckpt.close()

    def test_sync_mode_still_supported(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(1, _state())
        assert not ckpt.writing()
        assert ckpt.latest_step() == 1 and ckpt.verify_step(1) is True
        ckpt.close()

    def test_resume_step_from_env(self, monkeypatch):
        monkeypatch.setenv(tsettings.ENV_TPX_RESUME_STEP, "42")
        assert Checkpointer.resume_step_from_env() == 42
        monkeypatch.setenv(tsettings.ENV_TPX_RESUME_STEP, "")
        assert Checkpointer.resume_step_from_env() is None


class TestRobustness:
    def test_restore_falls_back_past_corrupt_latest(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(1, _state(1.0))
        ckpt.save(2, _state(2.0))
        ckpt.close()
        _corrupt_payload(tmp_path, 2)
        ckpt2 = Checkpointer(str(tmp_path), async_save=False)
        step, restored = ckpt2.restore_latest()
        assert step == 1 and _equal(restored, _state(1.0))
        assert [s for s, _ in ckpt2.skipped] == [2]
        # quarantined as evidence, and the manifest repaired
        assert (tmp_path / "2.corrupt").is_dir() and not (tmp_path / "2").exists()
        doc = json.loads((tmp_path / "MANIFEST.json").read_text())
        assert doc["latest_step"] == 1 and set(doc["steps"]) == {"1"}
        # the step can be saved again, and a second quarantine takes .corrupt1
        assert ckpt2.save(2, _state(2.5))
        ckpt2.close()
        _corrupt_payload(tmp_path, 2)
        step, restored = Checkpointer(str(tmp_path)).restore_latest()
        assert step == 1
        assert (tmp_path / "2.corrupt1").is_dir()

    def test_truncated_payload_without_digest_is_skipped(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(1, _state(1.0))
        ckpt.save(2, _state(2.0))
        ckpt.close()
        (tmp_path / "2" / ckpt_mod.PAYLOAD).write_bytes(b"truncated")
        doc = json.loads((tmp_path / "MANIFEST.json").read_text())
        del doc["steps"]["2"]  # no digest: the load itself must fail
        (tmp_path / "MANIFEST.json").write_text(json.dumps(doc))
        assert Checkpointer(str(tmp_path)).verify_step(2) is None
        step, restored = Checkpointer(str(tmp_path)).restore_latest()
        assert step == 1 and _equal(restored, _state(1.0))

    def test_all_corrupt_raises_instead_of_reinit(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(1, _state())
        ckpt.close()
        _corrupt_payload(tmp_path, 1)
        with pytest.raises(RuntimeError, match="failed to restore"):
            Checkpointer(str(tmp_path)).restore_latest()

    def test_empty_directory_roundtrip(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path / "fresh"))
        step, restored = ckpt.restore_latest()
        assert restored is None and not step
        ckpt.close()

    def test_save_interval_respected(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), save_interval_steps=5, async_save=False)
        saved = [s for s in range(1, 12) if ckpt.save(s, _state())]
        ckpt.close()
        assert saved == [5, 10]
        step, _ = Checkpointer(str(tmp_path)).restore_latest()
        assert step == 10

    def test_mismatched_state_raises_without_quarantine(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(1, _state())
        ckpt.close()
        other = {"w": torch.zeros(9), "b": torch.zeros(2, 3, dtype=torch.bfloat16),
                 "step": torch.tensor(0)}
        with pytest.raises(CheckpointMismatch, match="checkpoint"):
            Checkpointer(str(tmp_path)).restore_latest(into=other)
        with pytest.raises(CheckpointMismatch, match="entries"):
            Checkpointer(str(tmp_path)).restore_latest(into={"w": torch.zeros(8)})
        assert sorted(os.listdir(tmp_path)) == ["1", "MANIFEST.json"]


class TestReadOnly:
    def test_reader_skips_bad_steps_and_changes_nothing(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        for s in (1, 2):
            ckpt.save(s, _state(s))
        ckpt.close()
        _corrupt_payload(tmp_path, 2)
        before = _listing(tmp_path)
        manifest = (tmp_path / "MANIFEST.json").read_bytes()
        reader = Checkpointer(str(tmp_path), read_only=True)
        step, restored = reader.restore_latest(prefix="w")
        assert step == 1 and set(restored) == {"w"}
        assert torch.equal(restored["w"], _state(1.0)["w"])
        assert [s for s, _ in reader.skipped] == [2]
        assert _listing(tmp_path) == before
        assert (tmp_path / "MANIFEST.json").read_bytes() == manifest
        with pytest.raises(RuntimeError, match="read-only"):
            reader.save(3, _state())

    def test_reader_creates_nothing(self, tmp_path):
        reader = Checkpointer(str(tmp_path / "absent"), read_only=True)
        assert reader.restore_latest() == (None, None)
        assert not (tmp_path / "absent").exists()


class TestSnapshotThenWrite:
    def _gate(self, monkeypatch):
        gate = threading.Event()
        real = ckpt_mod.Checkpointer._write

        def gated(self, step, host):
            assert gate.wait(timeout=30)
            real(self, step, host)

        monkeypatch.setattr(ckpt_mod.Checkpointer, "_write", gated)
        return gate

    def test_background_write_completes_at_wait(self, tmp_path, monkeypatch):
        gate = self._gate(monkeypatch)
        ckpt = Checkpointer(str(tmp_path), async_save=True)
        assert ckpt.save(1, _state())
        # save() returned while the writer is held: nothing on disk yet
        assert ckpt.writing() and not (tmp_path / "1").exists()
        gate.set()
        ckpt.wait()
        assert not ckpt.writing()
        assert ckpt.verify_step(1) is True
        step, restored = ckpt.restore_latest()
        assert step == 1 and _equal(restored, _state())
        ckpt.close()

    def test_snapshot_is_fenced_before_mutation(self, tmp_path, monkeypatch):
        """The state captured is the state AT save() time, though the
        caller updates its tensors in place while the write is held."""
        gate = self._gate(monkeypatch)
        ckpt = Checkpointer(str(tmp_path), async_save=True)
        state = _state(3.0)
        ckpt.save(1, state)
        for t in state.values():
            t.fill_(-1)  # the optimizer's in-place update of the next step
        gate.set()
        ckpt.wait()
        _, restored = ckpt.restore_latest()
        assert _equal(restored, _state(3.0))
        ckpt.close()

    def test_crash_mid_background_write_falls_back(self, tmp_path, monkeypatch):
        ckpt = Checkpointer(str(tmp_path), async_save=True)
        ckpt.save(1, _state(1.0))
        ckpt.wait()
        real_save = torch.save

        def dying_save(obj, path, *a, **kw):
            with open(path, "wb") as f:
                f.write(b"PK\x03\x04partial")  # torn bytes in the .tmp step
            raise OSError("simulated kill mid-write")

        monkeypatch.setattr(ckpt_mod.torch, "save", dying_save)
        ckpt.save(2, _state(2.0))
        with pytest.raises(RuntimeError, match="background checkpoint write"):
            ckpt.wait()
        monkeypatch.setattr(ckpt_mod.torch, "save", real_save)
        # no torn step escaped the tmp + rename protocol
        assert sorted(os.listdir(tmp_path)) == ["1", "MANIFEST.json"]
        doc = json.loads((tmp_path / "MANIFEST.json").read_text())
        assert doc["latest_step"] == 1
        step, restored = Checkpointer(str(tmp_path)).restore_latest()
        assert step == 1 and _equal(restored, _state(1.0))
        ckpt.close()

    def test_leftover_tmp_step_is_ignored(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=False)
        ckpt.save(1, _state(1.0))
        (tmp_path / "2.tmp.99999").mkdir()  # a process killed mid-write
        (tmp_path / "2.tmp.99999" / ckpt_mod.PAYLOAD).write_bytes(b"torn")
        assert ckpt.all_steps() == [1]
        assert jsup.latest_checkpoint_step(str(tmp_path)) == 1
        ckpt.close()

    def test_writer_error_also_surfaces_at_next_save(self, tmp_path, monkeypatch):
        ckpt = Checkpointer(str(tmp_path), async_save=True)

        def dying_save(obj, path, *a, **kw):
            raise OSError("disk full")

        monkeypatch.setattr(ckpt_mod.torch, "save", dying_save)
        ckpt.save(1, _state())
        ckpt._writer.join(timeout=30)
        monkeypatch.undo()
        with pytest.raises(RuntimeError, match="background checkpoint write"):
            ckpt.save(2, _state())
        # the latched error is cleared: later saves work again
        assert ckpt.save(3, _state(3.0))
        ckpt.wait()
        assert ckpt.latest_step() == 3
        ckpt.close()

    def test_back_to_back_saves_serialize(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), async_save=True, max_to_keep=10)
        for s in range(1, 6):
            assert ckpt.save(s, _state(float(s)))
        ckpt.wait()
        assert ckpt.latest_step() == 5
        for s in range(1, 6):
            assert ckpt.verify_step(s) is True
            assert _equal(ckpt.restore(s), _state(float(s)))
        assert [w["step"] for w in ckpt.writes] == [1, 2, 3, 4, 5]
        ckpt.close()

    def test_buffers_are_reused_across_saves(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(1, _state(1.0))
        ptrs = {k: b.data_ptr() for k, b in ckpt._buffers.items()}
        ckpt.save(2, _state(2.0))
        ckpt.wait()
        assert {k: b.data_ptr() for k, b in ckpt._buffers.items()} == ptrs
        assert _equal(ckpt.restore(1), _state(1.0))
        ckpt.close()


class TestNoticeDuringAWrite:
    """A preemption notice lands while a periodic write is in flight: a save
    of the same step writes nothing more, a newer step's write starts beside
    the older one's fsync and digest, and the manifest never moves back."""

    @staticmethod
    def _gate_digest(monkeypatch, step):
        """Hold ``step``'s digest read-back until the returned event is set."""
        gate = threading.Event()
        real = ckpt_mod._digest_path

        def gated(path):
            if os.path.basename(path) == str(step):
                assert gate.wait(timeout=30)
            return real(path)

        monkeypatch.setattr(ckpt_mod, "_digest_path", gated)
        return gate

    def test_same_step_in_flight_is_written_once(self, tmp_path, monkeypatch):
        gate = self._gate_digest(monkeypatch, 5)
        ckpt = Checkpointer(str(tmp_path))
        assert ckpt.save(5, _state(5.0))
        returned = []
        notice = threading.Thread(
            target=lambda: returned.append(ckpt.save(5, _state(5.0), force=True)))
        notice.start()
        time.sleep(0.2)
        assert notice.is_alive()  # waits for the write in flight
        gate.set()
        notice.join(timeout=30)
        assert not notice.is_alive() and returned == [False]
        assert [w["step"] for w in ckpt.writes] == [5]
        assert ckpt.verify_step(5) is True and ckpt.latest_step() == 5
        assert ckpt.saves[-1]["rewrite_skipped"] is True
        ckpt.close()

    def test_same_step_on_disk_is_not_rewritten(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path))
        ckpt.save(5, _state(5.0))
        ckpt.wait()
        mtime = (tmp_path / "5" / ckpt_mod.PAYLOAD).stat().st_mtime_ns
        assert ckpt.save(5, _state(6.0), force=True) is False
        ckpt.wait()
        assert len(ckpt.writes) == 1
        assert (tmp_path / "5" / ckpt_mod.PAYLOAD).stat().st_mtime_ns == mtime
        assert _equal(ckpt.restore(5), _state(5.0))
        ckpt.close()

    def test_newer_step_writes_beside_the_older(self, tmp_path, monkeypatch):
        gate = self._gate_digest(monkeypatch, 1)
        ckpt = Checkpointer(str(tmp_path), max_to_keep=1)
        ckpt.save(1, _state(1.0))
        # step 1 is held in its digest; step 2 starts and finishes beside it
        assert ckpt.save(2, _state(2.0))
        deadline = time.monotonic() + 30
        while ckpt.verify_step(2) is not True and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ckpt.verify_step(2) is True
        assert json.loads((tmp_path / "MANIFEST.json").read_text())["latest_step"] == 2
        # a third save waits for the older write: two in flight at most
        third = threading.Thread(target=lambda: ckpt.save(3, _state(3.0)))
        third.start()
        time.sleep(0.2)
        assert third.is_alive()
        gate.set()
        third.join(timeout=30)
        assert not third.is_alive()
        ckpt.wait()
        doc = json.loads((tmp_path / "MANIFEST.json").read_text())
        # step 1's late finish moved nothing back; retention kept one step
        assert doc["latest_step"] == 3 and set(doc["steps"]) == {"3"}
        assert ckpt.all_steps() == [3]
        assert [w["step"] for w in ckpt.writes] == [1, 2, 3]
        assert all("write_s" in w for w in ckpt.writes)
        assert _equal(ckpt.restore(3), _state(3.0))
        ckpt.close()

    def test_the_older_writes_digest_survives_a_newer_prune(self, tmp_path, monkeypatch):
        """Retention by the newer write never deletes a step whose own
        write is still reading it back."""
        gate = self._gate_digest(monkeypatch, 1)
        ckpt = Checkpointer(str(tmp_path), max_to_keep=1)
        ckpt.save(1, _state(1.0))
        ckpt.save(2, _state(2.0))
        deadline = time.monotonic() + 30
        while ckpt.verify_step(2) is not True and time.monotonic() < deadline:
            time.sleep(0.01)
        assert (tmp_path / "1").is_dir()
        gate.set()
        ckpt.wait()  # step 1's write ends without error
        assert ckpt.all_steps() == [2]
        ckpt.close()


class TestContractWithJax:
    """A port-written directory, read by the JAX package's readers."""

    @pytest.fixture
    def ckpt_dir(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path / "ck"))
        for s in (2, 4):
            ckpt.save(s, _state(s))
        ckpt.close()
        return tmp_path / "ck"

    def test_settings_values_match(self):
        # every name of the JAX package's settings but its TPU and XLA
        # runtime variables, each with the JAX value
        tpu = {"ENV_TPU_WORKER_ID", "ENV_TPU_WORKER_HOSTNAMES", "ENV_TPU_SKIP_MDS_QUERY",
               "ENV_TPU_VISIBLE_CHIPS", "ENV_TPU_PROCESS_BOUNDS",
               "ENV_TPU_CHIPS_PER_PROCESS_BOUNDS", "ENV_JAX_PLATFORMS", "ENV_XLA_FLAGS",
               "ENV_MEGASCALE_COORDINATOR_ADDRESS", "ENV_MEGASCALE_NUM_SLICES",
               "ENV_MEGASCALE_SLICE_ID"}
        # and the port's own GPU names in their place
        gpu = {"ENV_CUDA_VISIBLE_DEVICES": "CUDA_VISIBLE_DEVICES",
               "ENV_TPX_GPU_ACCELERATOR_TYPE": "TPX_GPU_ACCELERATOR_TYPE",
               "ENV_TPX_GPU_TOPOLOGY": "TPX_GPU_TOPOLOGY",
               "ENV_TPX_NUM_SLICES": "TPX_NUM_SLICES"}
        names = {n for n in dir(tsettings) if n.isupper()}
        assert names == ({n for n in dir(jsettings) if n.isupper()} - tpu) | set(gpu)
        assert len(names) == 70
        assert {n: getattr(tsettings, n) for n in gpu} == gpu
        for name in names - set(gpu):
            got, want = getattr(tsettings, name), getattr(jsettings, name)
            assert got == want and type(got) is type(want), name

    def test_supervisor_reads_latest_step(self, ckpt_dir):
        assert jsup.latest_checkpoint_step(str(ckpt_dir)) == 4
        # and the fallback scan of digit-named steps, without the manifest
        (ckpt_dir / "MANIFEST.json").unlink()
        assert jsup.latest_checkpoint_step(str(ckpt_dir)) == 4

    def test_digest_recipe_matches(self, ckpt_dir):
        for s in (2, 4):
            path = str(ckpt_dir / str(s))
            assert ckpt_mod._digest_path(path) == jckpt._digest_path(path)
            assert ckpt_mod._digest_path(path) == jeval._digest_dir(path)
        doc = json.loads((ckpt_dir / "MANIFEST.json").read_text())
        assert set(doc) == {"latest_step", "steps"}
        assert doc["steps"]["4"] == {"digest": jckpt._digest_path(str(ckpt_dir / "4"))}

    def test_eval_gate_accepts_then_rejects_a_flipped_byte(self, ckpt_dir, tmp_path):
        step, digest = jeval.verify_checkpoint(str(ckpt_dir))
        assert step == 4 and digest
        outs = []
        for mod, name in ((jeval, "jax.json"), (teval, "port.json")):
            out = tmp_path / name
            assert mod.main(["--ckpt", str(ckpt_dir), "--out", str(out)]) == 0
            outs.append(out.read_bytes())
        assert outs[0] == outs[1]  # the port's record, byte for byte
        _corrupt_payload(ckpt_dir, 4)
        with pytest.raises(ValueError, match="digest mismatch"):
            jeval.verify_checkpoint(str(ckpt_dir))
        for mod in (jeval, teval):
            assert mod.main(["--ckpt", str(ckpt_dir), "--out", str(tmp_path / "x.json")]) == 1

    def test_leases_are_read_both_ways(self, tmp_path, monkeypatch):
        monkeypatch.setenv(tsettings.ENV_TPX_OBS_DIR, str(tmp_path))
        path = tgang.renew_lease(3, step=17, session="s1")
        assert path == os.path.join(str(tmp_path), "s1", "leases", "3.json")
        got = jgang.read_leases("s1")
        assert set(got) == {3} and got[3]["step"] == 17
        assert abs(got[3]["epoch_usec"] / 1e6 - time.time()) < 60
        jgang.renew_lease(5, step=2, session="s1")
        assert set(tgang.read_leases("s1")) == {3, 5}
        (tmp_path / "s1" / "leases" / "9.json").write_text("{torn")
        assert set(tgang.read_leases("s1")) == {3, 5}

    def test_session_dir_matches_the_launcher(self, tmp_path, monkeypatch):
        from torchx_tpu.obs import sinks as jsinks
        from torchx_tpu.util import session as jsession

        monkeypatch.setenv(tsettings.ENV_TPX_OBS_DIR, str(tmp_path))
        monkeypatch.setenv(tsettings.ENV_TPX_INTERNAL_SESSION_ID, "0123456789abcdef")
        monkeypatch.setattr(jsession, "_session_id", None)
        monkeypatch.setattr(tsession, "_session_id", None)
        assert sinks.default_session_name() == jsinks.default_session_name() == "tpx_01234567"
        assert sinks.trace_path() == jsinks.trace_path()
        assert sinks.obs_root() == jsinks.obs_root() == str(tmp_path)


def test_manifest_digest_of_a_multi_megabyte_payload(tmp_path):
    """The digest the writer records is the reference recipe's over the
    finished step directory (a payload of several read chunks)."""
    state = {"w": torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (5 << 20) + 3, dtype=np.uint8))}
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, state)
    ckpt.close()
    doc = json.loads((tmp_path / "MANIFEST.json").read_text())
    assert doc["steps"]["1"]["digest"] == jckpt._digest_path(str(tmp_path / "1"))
    assert set(ckpt.writes[0]) == {"step", "serialize_s", "fsync_s", "digest_s", "write_s",
                                   "bytes"}


def _mesh_at(spec, world, rank):
    """Rank ``rank``'s sizes and coordinates (no process group: the layout
    arithmetic needs no more)."""
    from torchx_tpu_torch.parallel.mesh import Mesh
    from torchx_tpu_torch.parallel.mesh_config import AXES, parse_mesh_spec

    sizes = parse_mesh_spec(spec).resolve(world)
    coords = np.unravel_index(rank, [sizes[a] for a in AXES])
    return Mesh(None, sizes, {a: int(c) for a, c in zip(AXES, coords)}, None, None,
                "gloo")


def _trainer_state():
    """The trainer's flat state of llama_tiny (its moments filled, so that
    no two entries are alike) and its specs: the embedding, ``wo`` and
    ``w_down`` shard their last dimension."""
    from torchx_tpu_torch.examples import train_llama as ttrain
    from torchx_tpu_torch.models import llama as tllama

    cfg = tllama.llama_tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(3))
    opt = ttrain.make_optimizer(tllama.leaves(params))
    gen = torch.Generator().manual_seed(4)
    for m in opt.mu + opt.nu:
        m.copy_(torch.randn(m.shape, generator=gen))
    opt.count = 7
    state = {k: v.clone() for k, v in ttrain.checkpoint_state(params, opt, 7).items()}
    return state, ttrain.checkpoint_specs(cfg)


def _save_as_gang(directory, spec, world, state, specs, step=7, **kw):
    """Every rank of a ``spec`` mesh saves its blocks of ``state``, each on
    a thread of its own (rank 0 waits for the others' files; they wait for
    its manifest; the staging name is the class fixture's). -> the ranks'
    checkpointers."""
    from torchx_tpu_torch.parallel.mesh import shard_extent

    ckpts = [Checkpointer(directory, mesh=_mesh_at(spec, world, r), specs=specs,
                          async_save=False, **kw) for r in range(world)]
    errors = []

    def one(ck):
        m = ck._mesh
        blocks = {k: v[shard_extent(specs.get(k, (None,) * v.dim()), tuple(v.shape),
                                    m.sizes, m.coords)].clone() for k, v in state.items()}
        try:
            ck.save(step, blocks)
        except BaseException as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(ck,)) for ck in ckpts]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    return ckpts


class TestShardedLayout:
    """A gang's step written by simulated ranks (threads, no process
    group): any layout reassembles bitwise and reshards into any other."""

    @pytest.fixture(autouse=True)
    def _one_staging_name(self, monkeypatch):
        """The name rank 0 would broadcast, the same on every thread."""
        monkeypatch.setattr(ckpt_mod.distributed, "broadcast_from_zero", lambda value: "t")

    LAYOUTS = [("fsdp=1", 1), ("fsdp=2", 2), ("fsdp=4", 4), ("dp=2,fsdp=2", 4)]

    @pytest.mark.parametrize("spec,world", LAYOUTS)
    def test_reassembled_and_resharded_bitwise(self, tmp_path, spec, world):
        from torchx_tpu_torch.parallel.mesh import shard_extent

        state, specs = _trainer_state()
        _save_as_gang(str(tmp_path), spec, world, state, specs)
        files = sorted(os.listdir(tmp_path / "7"))
        writers = {"fsdp=1": 0, "fsdp=2": 2, "fsdp=4": 4, "dp=2,fsdp=2": 2}[spec]
        if world == 1:
            assert files == [ckpt_mod.PAYLOAD]
        else:
            assert files == [ckpt_mod.INDEX] + [f"shard-{r}.pt" for r in range(writers)]
        whole = Checkpointer(str(tmp_path), read_only=True).restore(7)
        assert set(whole) == set(state)
        for k in state:
            assert torch.equal(whole[k], state[k]), k
        for into_spec, into_world in self.LAYOUTS:
            for rank in range(into_world):
                m = _mesh_at(into_spec, into_world, rank)
                want = {k: v[shard_extent(specs.get(k, (None,) * v.dim()), tuple(v.shape),
                                          m.sizes, m.coords)] for k, v in state.items()}
                live = {k: torch.zeros_like(v) for k, v in want.items()}
                Checkpointer(str(tmp_path), mesh=m, specs=specs).restore(
                    7, into=live)
                assert all(torch.equal(live[k], want[k]) for k in want), (into_spec, rank)

    def test_index_round_trips(self, tmp_path):
        state, specs = _trainer_state()
        _save_as_gang(str(tmp_path), "dp=2,fsdp=2", 4, state, specs)
        index = json.loads((tmp_path / "7" / ckpt_mod.INDEX).read_text())
        entries = {k: (tuple(specs.get(k, (None,) * v.dim())), tuple(v.shape), v.dtype)
                   for k, v in state.items()}
        assert ckpt_mod.layout_index(entries, index["mesh"]) == index
        assert ckpt_mod.index_files(index) == ["shard-0.pt", "shard-1.pt"]
        embed = index["entries"]["params.embed"]
        assert embed["spec"] == [None, "fsdp"] and embed["dtype"] == "float32"
        assert [(p["file"], p["start"], p["stop"]) for p in embed["pieces"]] == [
            ("shard-0.pt", [0, 0], [512, 32]), ("shard-1.pt", [0, 32], [512, 64])]
        assert index["entries"]["step"]["pieces"] == [
            {"file": "shard-0.pt", "start": [], "stop": []}]
        doc = json.loads((tmp_path / "MANIFEST.json").read_text())
        assert doc["latest_step"] == 7 and doc["steps"]["7"]["tag"] == "t"
        assert jeval.verify_checkpoint(str(tmp_path))[0] == 7

    def test_world_one_payload_is_todays_bytes(self, tmp_path):
        """At a world of one the step is the one torch.save file of the
        whole state, byte for byte, with or without a mesh of one."""
        state, specs = _trainer_state()
        for sub, mesh in (("plain", None), ("mesh", _mesh_at("fsdp=-1", 1, 0))):
            ckpt = Checkpointer(str(tmp_path / sub), mesh=mesh, specs=specs)
            ckpt.save(7, state)
            ckpt.close()
        os.makedirs(tmp_path / "direct")
        torch.save(state, str(tmp_path / "direct" / ckpt_mod.PAYLOAD))
        want = (tmp_path / "direct" / ckpt_mod.PAYLOAD).read_bytes()
        for sub in ("plain", "mesh"):
            assert os.listdir(tmp_path / sub / "7") == [ckpt_mod.PAYLOAD]
            assert (tmp_path / sub / "7" / ckpt_mod.PAYLOAD).read_bytes() == want

    def test_a_rank_that_never_writes_leaves_no_step(self, tmp_path, monkeypatch):
        """Rank 0 of two alone: its wait for rank 1's file times out, the
        write fails at wait(), and no step, staging directory or manifest
        entry is left that looks finished."""
        state, specs = _trainer_state()
        from torchx_tpu_torch.parallel.mesh import shard_extent

        m = _mesh_at("fsdp=2", 2, 0)
        monkeypatch.setattr(ckpt_mod, "COMMIT_TIMEOUT_S", 0.5)
        ck = Checkpointer(str(tmp_path), mesh=m, specs=specs)
        blocks = {k: v[shard_extent(specs.get(k, (None,) * v.dim()), tuple(v.shape),
                                    m.sizes, m.coords)].clone() for k, v in state.items()}
        assert ck.save(7, blocks)
        with pytest.raises(RuntimeError, match="background checkpoint write") as info:
            ck.wait()
        assert isinstance(info.value.__cause__, TimeoutError)
        assert os.listdir(tmp_path) == []
        assert ck.all_steps() == []
