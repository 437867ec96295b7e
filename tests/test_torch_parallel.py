"""Frame-sharded Monte-Carlo and code-axis sharding over a ``torch.distributed``
group, on the CPU.

One module-scoped fixture starts ONE world of 4 gloo ranks (subprocesses with
the environment ``torchrun`` gives: RANK, WORLD_SIZE, MASTER_ADDR, a free
MASTER_PORT).  Each rank imports only the port, runs on one torch thread,
joins the group through the ``--distributed`` path of a CLI, runs every
scenario below and writes one JSON.  The tests hold the 4-rank counts to the
port's unsharded runs (equal: randomness is keyed by global frame id) and to
JAX's Monte-Carlo engine sharded over its 8 virtual CPU devices (the float32
noise may put one frame in 256 on the other side of a decision, as in
``test_torch_montecarlo.py``), the code-sharded QC decode and polar
transform to their unsharded versions bit for bit, and ``--host-devices 2``
to the unsharded CLI.
"""

import inspect
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import polarcode_and_ldpc_tpu as jfec
import polarcode_and_ldpc_tpu_torch as tfec
from polarcode_and_ldpc_tpu.parallel import default_mesh as jdefault_mesh
from polarcode_and_ldpc_tpu.parallel import mesh as jmesh
from polarcode_and_ldpc_tpu.sim import montecarlo as jmc
from polarcode_and_ldpc_tpu.sim import pipelines as jpipes
from polarcode_and_ldpc_tpu.sim import scaling as jscaling
from polarcode_and_ldpc_tpu_torch.cli import _common as tcommon
from polarcode_and_ldpc_tpu_torch.cli import sc_vs_scl as tsc_vs_scl
from polarcode_and_ldpc_tpu_torch.models.ldpc.qc import make_qc_bp_decoder
from polarcode_and_ldpc_tpu_torch.models.polar.encoder import polar_transform
from polarcode_and_ldpc_tpu_torch.parallel import mesh as tmesh
from polarcode_and_ldpc_tpu_torch.sim import montecarlo as tmc
from polarcode_and_ldpc_tpu_torch.sim import sweep as tsweep

RANKS = 4
WORLD_TIMEOUT_S = 180


# -- what every rank and the unsharded reference run (sent to the ranks as source) ----

def port_steps():
    """name → (step, message bits): SC N=64, CA-SCL N=64 L=4 (CRC-8, chunk
    16), BP (96, 48) with iterations, at SNRs (``SNRS``) where each makes
    frame errors to count."""
    import polarcode_and_ldpc_tpu_torch as fec
    from polarcode_and_ldpc_tpu_torch.sim import make_ldpc_pipeline, make_polar_pipeline

    frozen, _ = fec.construct_polar_code(64, 32, "bhattacharyya", 2.0, device="cpu")
    enc = fec.LDPCEncoder(96, 48, dv=3, dc=6, seed=42, device="cpu")
    kw = dict(device="cpu", rng_x64=True)
    return {
        "sc": (make_polar_pipeline(64, 32, frozen, -1.0, decoder="sc", **kw), 32),
        "cascl": (make_polar_pipeline(64, 32, frozen, -2.0, decoder="ca-scl", list_size=4,
                                      crc_polynomial="CRC-8", scl_chunk=16, **kw), 24),
        "bp": (make_ldpc_pipeline(enc.H, enc.G, -1.0, decoder="bp", max_iter=10,
                                  message_idx=enc.info_positions, **kw), 48),
    }


def mc_cases():
    """case → (simulator keywords, run keywords, checkpoint first): an
    early-stop crossing per frame and in scalar mode, two chunks a dispatch, a
    chunk that is not a multiple of the 4 ranks with a budget that is not a
    chunk multiple (both modes), and a resumed run."""
    stop = dict(num_frames=256, max_errors=20, seed=5)
    return {
        "per_frame": (dict(chunk_frames=64), stop, False),
        "scalar": (dict(chunk_frames=64, reduction="scalar"), stop, False),
        "dispatch2": (dict(chunk_frames=32, chunks_per_dispatch=2), stop, False),
        "odd_chunk": (dict(chunk_frames=50), dict(num_frames=250, seed=5), False),
        "odd_chunk_scalar": (dict(chunk_frames=50, reduction="scalar"),
                             dict(num_frames=250, seed=5), False),
        "resume": (dict(chunk_frames=32), dict(num_frames=256, max_errors=40, seed=5), True),
    }


def run_case(step, k, case, mesh, ck_dir):
    from polarcode_and_ldpc_tpu_torch.sim import MonteCarloSimulator

    sim_kw, run_kw, resume = case
    sim = MonteCarloSimulator(step, k, mesh=mesh, **sim_kw)
    if resume:
        ck = ck_dir / f"ck_{k}.json"
        sim.run(run_kw["num_frames"] // 2, seed=run_kw["seed"], checkpoint_path=ck,
                checkpoint_every_chunks=1)
        res = sim.run(**run_kw, checkpoint_path=ck)
    else:
        res = sim.run(**run_kw)
    return [res.frames, res.bit_errors, res.frame_errors, res.total_iterations,
            res.iteration_frames]


def qc_inputs():
    """JAX's code-sharding test code (n=384, k=192, z=32, seed 5: 12 variable
    blocks) and 8 noisy frames of the all-zero codeword."""
    import numpy as np

    from polarcode_and_ldpc_tpu_torch.models.ldpc.matrix import qc_base_matrix

    base = qc_base_matrix(384, 192, 32, dv=3, dc=6, seed=5)
    llr = (2.0 + 1.5 * np.random.default_rng(3).standard_normal((8, 384))).astype(np.float32)
    return base, llr


QC_DECODERS = {"bp": dict(max_iter=12), "layered_nms": dict(
    max_iter=12, variant="nms", normalization=0.75, schedule="layered")}
QC_MESHES = [("bp", (1, 4)), ("bp", (2, 2)), ("bp", (4, 1)), ("layered_nms", (2, 2))]
CLI_ARGS = ["--mode", "quick", "--N", "32", "--K", "16", "--list-sizes", "1,2",
            "--num-frames", "256", "--max-errors", "30", "--batch-size", "64",
            "--snr-db", "0.0", "--device", "cpu"]


def rank_main(out_dir, qc_meshes, qc_decoders, cli_args):
    """One rank of the world: the --distributed CLI path, then every scenario."""
    import json
    import os
    from pathlib import Path

    import numpy as np
    import torch

    torch.set_num_threads(1)
    from polarcode_and_ldpc_tpu_torch.cli import sc_vs_scl
    from polarcode_and_ldpc_tpu_torch.models.ldpc.qc import make_qc_bp_decoder
    from polarcode_and_ldpc_tpu_torch.parallel import (code_sharded_decode,
                                                       code_sharded_polar_transform,
                                                       default_mesh, mesh_2d)
    from polarcode_and_ldpc_tpu_torch.sim import measure_scaling, run_snr_sweep

    out = Path(out_dir)
    rank = int(os.environ["RANK"])
    sc_vs_scl.main(cli_args + ["--distributed", "--output-dir", str(out / "cli")])
    mesh = default_mesh(device="cpu")
    res: dict = {"mc": {}, "qc": {}, "transform": {}}
    steps = port_steps()
    for name, (step, k) in steps.items():
        for case_name, case in mc_cases().items():
            res["mc"][f"{name}/{case_name}"] = run_case(step, k, case, mesh, out)
    sweep = run_snr_sweep(lambda s: port_sweep_step(s), 32, [-1.0, 0.0], num_frames=128,
                          max_errors=20, seed=42, chunk_frames=64, mesh=mesh)
    res["sweep"] = {k: sweep[k] for k in ("frames_tested", "bit_errors", "frame_errors")}
    base, llr = qc_inputs()
    for dec_name, shape in qc_meshes:
        dec = make_qc_bp_decoder(base, 32, device="cpu", **qc_decoders[dec_name])
        m2 = mesh_2d(*shape, device="cpu")
        bits, iters = code_sharded_decode(dec, m2)(torch.from_numpy(llr))
        res["qc"][f"{dec_name}/{shape[0]}x{shape[1]}"] = {
            "coord": list(m2.get_coordinate()), "bits": bits.tolist(), "iters": iters.tolist()}
    u = np.random.default_rng(4).integers(0, 2, (8, 64)).astype(np.int8)
    for shape in ((1, 4), (2, 2)):
        m2 = mesh_2d(*shape, device="cpu")
        x = code_sharded_polar_transform(m2)(torch.from_numpy(u))
        res["transform"][f"{shape[0]}x{shape[1]}"] = {"coord": list(m2.get_coordinate()),
                                                     "x": x.tolist()}
    res["scaling"] = measure_scaling(steps["sc"][0], frames_per_device=32, iters=1, warmup=1)
    (out / f"rank{rank}.json").write_text(json.dumps(res))


def port_sweep_step(snr):
    import polarcode_and_ldpc_tpu_torch as fec
    from polarcode_and_ldpc_tpu_torch.sim import make_polar_pipeline

    frozen, _ = fec.construct_polar_code(64, 32, "bhattacharyya", 2.0, device="cpu")
    return make_polar_pipeline(64, 32, frozen, snr, decoder="sc", device="cpu")


# -- the world ----------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's side, module fixtures included: many
    small ops cost a fraction on one thread of what waking torch's thread pool
    costs on a busy host, and the cores of the other test workers are left
    alone.  The count is restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _child_env(**extra) -> dict:
    root = str(Path(__file__).resolve().parents[1])
    return dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])),
                **extra)


def jax_runs() -> dict:
    """JAX's engine on its 8 virtual devices (``default_mesh()``): the
    per-frame early-stop case of each step (chunk 64, a multiple of 8)."""
    frozen, _ = jfec.construct_polar_code(64, 32, "bhattacharyya", 2.0)
    enc = tfec.LDPCEncoder(96, 48, dv=3, dc=6, seed=42, device="cpu")
    steps = {
        "sc": (jpipes.make_polar_pipeline(64, 32, frozen, -1.0, decoder="sc"), 32),
        "cascl": (jpipes.make_polar_pipeline(64, 32, frozen, -2.0, decoder="ca-scl",
                                             list_size=4, crc_polynomial="CRC-8",
                                             scl_chunk=16), 24),
        "bp": (jpipes.make_ldpc_pipeline(enc.H, enc.G, -1.0, decoder="bp", max_iter=10,
                                         message_idx=enc.info_positions), 48),
    }
    assert len(jax.devices()) == 8
    _, run_kw, _ = mc_cases()["per_frame"]
    out = {}
    for name, (step, k) in steps.items():
        res = jmc.MonteCarloSimulator(step, k, chunk_frames=64, mesh=jdefault_mesh()).run(**run_kw)
        out[name] = [res.frames, res.bit_errors, res.frame_errors, res.total_iterations,
                     res.iteration_frames]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world and, started beside it, the ``--host-devices 2``
    launch (a thread); while they run, this process makes the references:
    the port's unsharded runs, JAX's sharded runs and the unsharded CLI."""
    out = tmp_path_factory.mktemp("world")
    source = "\n\n".join(inspect.getsource(f) for f in (port_steps, mc_cases, run_case,
                                                        qc_inputs, port_sweep_step, rank_main))
    code = (f"{source}\n\nrank_main({str(out)!r}, {QC_MESHES!r}, {QC_DECODERS!r}, "
            f"{CLI_ARGS!r})\n")
    env = _child_env(MASTER_ADDR="localhost", MASTER_PORT=str(tcommon.free_port()),
                     WORLD_SIZE=str(RANKS), LOCAL_WORLD_SIZE=str(RANKS))
    logs = [open(out / f"rank{r}.log", "w") for r in range(RANKS)]
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=logs[r],
                              stderr=subprocess.STDOUT,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(RANKS)]
    host = {"dir": out / "host_devices"}
    launch = threading.Thread(daemon=True, target=lambda: host.update(result=tsc_vs_scl.main(
        ["--host-devices", "2"] + CLI_ARGS + ["--output-dir", str(host["dir"])])))
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("OMP_NUM_THREADS", "1")  # the launched ranks inherit this
            mp.setenv("MKL_NUM_THREADS", "1")
            launch.start()
            refs = {"unsharded": {f"{name}/{case_name}": run_case(step, k, case, None,
                                                                  out / "unsharded")
                                  for name, (step, k) in port_steps().items()
                                  for case_name, case in mc_cases().items()},
                    "cli": tsc_vs_scl.main(CLI_ARGS + ["--output-dir", str(out / "plain")]),
                    "sweep": tsweep.run_snr_sweep(port_sweep_step, 32, [-1.0, 0.0],
                                                  num_frames=128, max_errors=20, seed=42,
                                                  chunk_frames=64),
                    "jax": jax_runs()}
            launch.join(WORLD_TIMEOUT_S)
        for p in procs:
            p.wait(timeout=WORLD_TIMEOUT_S)
    finally:
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, \
            f"rank {r} exited with {p.returncode}:\n{(out / f'rank{r}.log').read_text()[-4000:]}"
    ranks = [json.loads((out / f"rank{r}.json").read_text()) for r in range(RANKS)]
    return out, ranks, refs, host


# -- Monte-Carlo over 4 ranks ---------------------------------------------------------------

@pytest.mark.parametrize("key", [f"{s}/{c}" for s in ("sc", "cascl", "bp") for c in mc_cases()])
def test_sharded_montecarlo_equals_unsharded(world, key):
    """frames, bit errors, frame errors, iterations and iteration frames."""
    _, ranks, refs, _ = world
    got = ranks[0]["mc"][key]
    assert got == refs["unsharded"][key]
    assert all(r["mc"][key] == got for r in ranks)  # every rank returns the same result
    if "odd_chunk" in key:
        assert got[0] == 250
    elif not key.endswith("resume"):
        assert got[2] == 20 and got[0] < 256  # the early stop crossed
    assert (got[3] > 0) == key.startswith("bp")


@pytest.mark.parametrize("name", ["sc", "cascl", "bp"])
def test_sharded_montecarlo_equals_jax_eight_devices(world, name):
    """The 4-rank early-stop run against JAX's engine sharded over 8 devices
    on the same frame ids and seed."""
    _, ranks, refs, _ = world
    got, want = ranks[0]["mc"][f"{name}/per_frame"], refs["jax"][name]
    print(f"{name}: 4 ranks {got}, JAX 8 devices {want}")
    assert got == want


def test_distributed_cli_and_sweep_equal_unsharded(world):
    """The CLI's --distributed path (rank 0 alone writes) and
    ``run_snr_sweep(mesh=)`` against their unsharded runs."""
    out, ranks, refs, _ = world
    got = json.loads((out / "cli" / "quick_results.json").read_text())
    for name in ("sc", "scl_1", "scl_2"):
        for field in ("frames", "bit_errors", "frame_errors"):
            assert got[name][field] == refs["cli"][name][field], (name, field)
    assert sum(got[name]["frame_errors"] for name in ("sc", "scl_1", "scl_2")) > 0
    for r in ranks:
        assert r["sweep"] == {k: refs["sweep"][k] for k in ("frames_tested", "bit_errors",
                                                            "frame_errors")}
    assert sum(refs["sweep"]["frame_errors"]) > 0


def test_host_devices_cli_equals_unsharded(world):
    """``--host-devices 2`` started two local CPU ranks over gloo; the
    launching process ran nothing itself, and rank 0 wrote the results."""
    _, _, refs, host = world
    assert "result" in host and host["result"] is None
    got = json.loads((host["dir"] / "quick_results.json").read_text())
    for name in ("sc", "scl_1", "scl_2"):
        for field in ("frames", "bit_errors", "frame_errors"):
            assert got[name][field] == refs["cli"][name][field], (name, field)


# -- code-axis sharding ------------------------------------------------------------------

def _assemble(ranks, section, key, field, shape, rows, cols):
    """The global array from each rank's block and its (frames, code) coordinate."""
    f, c = shape
    out = np.zeros((rows, cols) if cols else (rows,), np.int64)
    for r in ranks:
        blk = r[section][key]
        fi, ci = blk["coord"]
        a = np.asarray(blk[field])
        rs = slice(fi * rows // f, (fi + 1) * rows // f)
        if cols:
            out[rs, ci * cols // c:(ci + 1) * cols // c] = a
        else:
            out[rs] = a
    return out


@pytest.mark.parametrize("dec_name,shape", QC_MESHES)
def test_qc_code_sharded_bit_identical(world, dec_name, shape):
    """Every rank holds n / code columns; the blocks put together equal the
    unsharded decoder bit for bit, iteration counts included (the unsharded
    decoder equals JAX's: ``test_torch_qc.py``)."""
    _, ranks, _, _ = world
    base, llr = qc_inputs()
    key = f"{dec_name}/{shape[0]}x{shape[1]}"
    for r in ranks:
        assert np.asarray(r["qc"][key]["bits"]).shape == (8 // shape[0], 384 // shape[1])
    bits = _assemble(ranks, "qc", key, "bits", shape, 8, 384)
    iters = _assemble(ranks, "qc", key, "iters", shape, 8, 0)
    want_bits, want_iters = make_qc_bp_decoder(base, 32, device="cpu",
                                               **QC_DECODERS[dec_name])(torch.from_numpy(llr))
    np.testing.assert_array_equal(bits, want_bits.numpy())
    np.testing.assert_array_equal(iters, want_iters.numpy())
    assert len(set(iters.tolist())) > 1  # frames stopped at different iterations


def test_polar_transform_code_sharded_bit_identical(world):
    _, ranks, _, _ = world
    u = np.random.default_rng(4).integers(0, 2, (8, 64)).astype(np.int8)
    want = polar_transform(torch.from_numpy(u)).numpy()
    for shape in ((1, 4), (2, 2)):
        got = _assemble(ranks, "transform", f"{shape[0]}x{shape[1]}", "x", shape, 8, 64)
        np.testing.assert_array_equal(got, want)


def test_measure_scaling_keys_equal_jax(world):
    _, ranks, _, _ = world
    got = ranks[0]["scaling"]
    keys = set(inspect.signature(jscaling.measure_scaling).parameters)
    assert keys == {"step_fn", "frames_per_device", "device_counts", "iters", "warmup"}
    assert set(got) == {"frames_per_device", "points"} and got["frames_per_device"] == 32
    assert [p["devices"] for p in got["points"]] == [1, 2, 4]
    for p in got["points"]:
        assert set(p) == {"devices", "batch", "seconds", "frames_per_second", "speedup",
                          "efficiency"}
        assert p["batch"] == 32 * p["devices"] and p["seconds"] > 0
    assert got["points"][0]["speedup"] == got["points"][0]["efficiency"] == 1.0
    assert all(r["scaling"] == got for r in ranks)  # each point's time is the slowest rank's


def test_mesh_helpers_equal_jax():
    """``pad_to_multiple`` and the names of the module; the placements of a
    one-rank mesh in this process (made here, taken down after)."""
    assert [tmesh.pad_to_multiple(n, 4) for n in (1, 4, 50, 64)] == \
        [jmesh.pad_to_multiple(n, 4) for n in (1, 4, 50, 64)]
    names = {n for n in dir(jmesh) if n.isupper() or callable(getattr(jmesh, n))}
    assert {"FRAME_AXIS", "CODE_AXIS", "default_mesh", "multihost_mesh", "frame_sharding",
            "replicated_sharding", "mesh_2d", "code_sharded_decode",
            "code_sharded_polar_transform", "pad_to_multiple"} <= names & set(dir(tmesh))
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        mesh = tmesh.default_mesh(device="cpu")
        assert mesh.mesh_dim_names == ("frames",) and mesh.size() == 1
        x = torch.arange(12).reshape(4, 3)
        assert torch.equal(tmesh.frame_sharding(mesh).local(x), x)
        assert torch.equal(tmesh.replicated_sharding(mesh).local(x), x)
        sim = tmc.MonteCarloSimulator(port_steps()["sc"][0], 32, chunk_frames=50, mesh=mesh)
        assert sim.chunk_frames == 50
    finally:
        dist.destroy_process_group()
