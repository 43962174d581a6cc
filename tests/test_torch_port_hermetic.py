"""Hermetic guards for the PyTorch/CUDA port: it never imports jax or the
JAX package, and its entry points never fall back to the CPU quietly."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_port_and_chip_smoke_import_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import onset_fingerprinting_torch as pkg\n"
        "names = set()\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.add(m.name[len(pkg.__name__) + 1:])\n"
        "new = {'core.coords', 'core.ring_buffer', 'locate.geometry',\n"
        "       'locate.trilateration', 'locate.multilaterate',\n"
        "       'detect.refine', 'ops.locate_block', 'realtime.actions',\n"
        "       'realtime.engine', 'tools.realtime_sim',\n"
        "       'models.train', 'models.fcnn', 'models.cnn',\n"
        "       'models.experiment', 'models.hpo', 'core.audio_io',\n"
        "       'core.posd', 'data.synth', 'data.frames', 'data.datasets',\n"
        "       'locate.calibration', 'tools.fingerprint_capability',\n"
        "       'detect.amplitude', 'detect.grouping', 'tools.mine_hits',\n"
        "       'tools.train_setup', 'realtime.setup_io',\n"
        "       'models.torch_import', 'realtime.analysis', 'realtime.main',\n"
        "       'runtime_native', 'ops.stft', 'ops.envelope',\n"
        "       'detect.spectral', 'data.augment', 'models.rnn',\n"
        "       'models.jax_import', 'tools.zone_classifier',\n"
        "       'core.backend_probe', 'parallel', 'parallel.mesh',\n"
        "       'parallel.distributed', 'parallel.sharding', 'utils',\n"
        "       'utils.metrics', 'utils.eval', 'utils.plots',\n"
        "       'tools.modify_hits', 'tools.modify_hits_mc',\n"
        "       'tools.choose_od_settings'}\n"
        "assert new <= names, new - names\n"
        "import onset_fingerprinting_torch.tools.fingerprint_anatomy\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith(('jax.', 'flax', 'bench',\n"
        "                              'onset_fingerprinting_tpu')))\n"
        "assert not bad, bad\n"
        "print('CLEAN')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CLEAN" in out.stdout


def test_data_and_detect_import_no_pandas():
    """The card's machine has no pandas: importing the data and detect
    packages (POSD, the augmentations, the detectors) must not need it."""
    code = (
        "import sys\n"
        "import onset_fingerprinting_torch.data\n"
        "import onset_fingerprinting_torch.detect\n"
        "import onset_fingerprinting_torch.tools.zone_classifier\n"
        "assert 'pandas' not in sys.modules\n"
        "print('CLEAN')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "CLEAN" in out.stdout


def test_classification_entry_points_default_to_the_card():
    """The classification slice's entry points run on the card unless asked
    for the CPU: no quiet fallback."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from onset_fingerprinting_torch.data.datasets import POSD
    from onset_fingerprinting_torch.detect import (
        detect_onsets,
        detect_onsets_spectral,
    )
    from onset_fingerprinting_torch.ops.envelope import minmax_init
    from onset_fingerprinting_torch.ops.xcorr import streaming_cc_init
    from onset_fingerprinting_torch.tools import zone_classifier

    x = np.zeros(4096, np.float32)
    cuda = pytest.raises(RuntimeError, match="CUDA is not available")
    with cuda:
        detect_onsets_spectral(x)
    with cuda:
        detect_onsets(x, method="spectral")
    with cuda:
        POSD.from_audio_onsets([x], [[100]], 96000, 64, n_rounds_aug=0)
    with cuda:
        zone_classifier.run(hits=2, epochs=1)
    with cuda:
        minmax_init(3)
    with cuda:
        streaming_cc_init(64)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from onset_fingerprinting_torch.models.cccnn import CCCNN
    from onset_fingerprinting_torch.ops.fused_detector import (
        make_fused_detector,
    )
    from onset_fingerprinting_torch.pipeline import (
        fleet_detector_config,
        make_detect_fingerprint,
    )
    from onset_fingerprinting_torch.tools import fingerprint_anatomy
    from onset_fingerprinting_torch.workload import FLAGSHIP, make_audio

    cfg = fleet_detector_config(2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_fused_detector(cfg)
    model = CCCNN(input_size=256, **FLAGSHIP)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_detect_fingerprint(cfg, model, 2, 20480, 128)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_audio(128, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fingerprint_anatomy.main(n_streams=32, chunk=20480, capacity=128)
    from onset_fingerprinting_torch.core.config import TrainConfig
    from onset_fingerprinting_torch.data.datasets import MCPOSD
    from onset_fingerprinting_torch.locate.calibration import (
        train_location_model,
    )
    from onset_fingerprinting_torch.models.train import Trainer
    from onset_fingerprinting_torch.tools import fingerprint_capability

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(model, TrainConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MCPOSD(np.zeros((400, 4), np.float32), np.array([[100] * 4]),
               np.zeros((1, 2), np.float32), frame_length=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_location_model(np.zeros((4, 6), np.float32),
                             np.zeros((4, 2), np.float32), num_epochs=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        fingerprint_capability.run(hits=8, epochs=1)


def test_setup_loop_entry_points_default_to_the_card(tmp_path):
    """The player's setup loop: mining, calibration, the setup's model, the
    engine built from a setup and the analysis side channel run on the card
    unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from onset_fingerprinting_torch.core.config import RealtimeConfig
    from onset_fingerprinting_torch.core.ring_buffer import CircularArray
    from onset_fingerprinting_torch.detect.amplitude import (
        AmplitudeOnsetDetector,
        detect_onsets_amplitude,
    )
    from onset_fingerprinting_torch.locate import calibration as cal
    from onset_fingerprinting_torch.locate.multilaterate import (
        Multilaterate3D,
        build_locator_tables,
        locator_init,
        make_locate_update,
    )
    from onset_fingerprinting_torch.models.fcnn import FCNN, FCNNBundle
    from onset_fingerprinting_torch.realtime import main, setup_io
    from onset_fingerprinting_torch.realtime.analysis import OnlineAnalysis
    from onset_fingerprinting_torch.tools.mine_hits import mine_file

    x = np.zeros((1024, 3), np.float32)
    cuda = pytest.raises(RuntimeError, match="CUDA is not available")
    with cuda:
        detect_onsets_amplitude(x)
    with cuda:
        AmplitudeOnsetDetector(3, 128)
    from onset_fingerprinting_torch.core.audio_io import write_wav

    write_wav(tmp_path / "x.wav", x, 96000)
    with cuda:
        mine_file(tmp_path / "x.wav", tmp_path / "m")
    with cuda:
        cal.calibrate(np.zeros((44, 3)))
    with cuda:
        cal.optimize_positions(np.zeros((4, 2)), np.zeros((3, 3)),
                               np.zeros((4, 3)), num_epochs=1)
    with cuda:
        cal.tdoa_calib_errors(np.zeros(9), np.zeros((4, 3)),
                              np.zeros((4, 2)))
    loc = Multilaterate3D([(0.9, 0, 0), (0.9, 120, 0), (0.9, 240, 0)])
    with cuda:
        build_locator_tables(loc)
    with cuda:
        make_locate_update(loc)
    with cuda:
        locator_init(8)
    margs = {"output_size": 2, "hidden_layers": [4]}
    setup_io.save_setup([[0.9, 0, 0], [0.9, 120, 0], [0.9, 240, 0]], "air",
                        None, FCNNBundle(FCNN(2, hidden_layers=(4,))),
                        margs, tmp_path / "setup")
    with cuda:
        setup_io.load_setup(tmp_path / "setup")
    with cuda:
        main.build_engine(tmp_path / "setup")
    with cuda:
        OnlineAnalysis(RealtimeConfig(max_recording_seconds=1),
                       CircularArray(np.zeros((96000, 1), np.float32)))


def test_locate_kernel_refuses_an_fcnn_outside_its_plan():
    """An FCNN the locate kernel cannot run raises when the LocateBlock is
    built for the card, before anything reaches the card: no plain
    fallback.  (On the CPU the plain version takes it.)"""
    from onset_fingerprinting_torch.locate.multilaterate import (
        Multilaterate3D,
    )
    from onset_fingerprinting_torch.models.fcnn import FCNN, FCNNBundle
    from onset_fingerprinting_torch.ops import _cuda
    from onset_fingerprinting_torch.ops.locate_block import LocateBlock

    loc = Multilaterate3D([(0.9, 0, 0), (0.9, 120, 0), (0.9, 240, 0)])
    before = (_cuda.LOCATE_BLOCK.launches, _cuda.LOCATE_BLOCK.plain_calls)
    # three lag features in; two vectors of 30000 units past the launch's
    # shared memory
    for inputs, hidden in ((3, (8,)), (2, (30000,))):
        wide = FCNNBundle(FCNN(inputs, hidden_layers=hidden))
        for device in ("cuda", None):
            with pytest.raises(ValueError, match="plan"):
                LocateBlock(loc, 3, 128, model=wide, device=device)
    assert (_cuda.LOCATE_BLOCK.launches,
            _cuda.LOCATE_BLOCK.plain_calls) == before
    lb = LocateBlock(loc, 3, 128, model=wide, device="cpu")
    assert lb.fcnn is None


def test_parallel_entry_points_default_to_the_card(monkeypatch):
    """The parallel package runs on the card unless asked for the CPU:
    meshes, the sharded paths (through their mesh) and the trainer's mesh;
    ``init_distributed`` takes gloo only with ``device="cpu"`` (NCCL
    otherwise, which needs the card) and is a no-op for one process or
    without a launcher's environment."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    import torch.distributed as dist

    from onset_fingerprinting_torch.parallel import (
        default_mesh,
        global_mesh,
        init_distributed,
        make_mesh,
        pod_env_detected,
    )

    cuda = pytest.raises(RuntimeError, match="CUDA is not available")
    with cuda:
        make_mesh((1,), ("data",))
    with cuda:
        default_mesh()
    with cuda:
        global_mesh()
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert not pod_env_detected()
    assert init_distributed() is False  # no launcher: a no-op
    assert init_distributed("localhost:1", 1, 0) is False  # one process
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert pod_env_detected()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert not pod_env_detected() and init_distributed() is False
    # two processes and no device named: NCCL, so the card; it raises
    # before any rendezvous is tried
    with cuda:
        init_distributed("localhost:1", 2, 0)
    assert not dist.is_initialized()


def test_tools_and_utils_entry_points_default_to_the_card(tmp_path):
    """The detector tuner, the profiler capture, the serve loop and its
    split run on the card unless asked for the CPU: no quiet fallback."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    from onset_fingerprinting_torch.tools import realtime_sim, serve_split
    from onset_fingerprinting_torch.tools.choose_od_settings import (
        DetectorTuner,
    )
    from onset_fingerprinting_torch.utils.metrics import profile_trace

    cuda = pytest.raises(RuntimeError, match="CUDA is not available")
    with cuda:
        DetectorTuner(np.zeros((4096, 2), np.float32))
    with cuda:
        with profile_trace(tmp_path / "trace"):
            pass
    with cuda:
        realtime_sim.serve(seconds=0.5)
    with cuda:
        realtime_sim.main(["--serve", "--seconds", "0.5"])
    with cuda:
        serve_split.main(["--seconds", "0.5"])
    assert not (tmp_path / "trace").exists()
