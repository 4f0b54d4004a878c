"""The port's CLI end to end on the CPU: a chunked high-rate replay, and a
replay that writes its map and its state, localizes against that map and
resumes from that state.  Its configurations are in test_torch_host.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)


def test_cli_chunked_high_rate_replay(tmp_path, capsys):
    """``--chunked --high-rate`` on the CPU, JAX's default profile (vlp_16)
    and its configuration: 12 scans, so the IMU's 1 s static init
    completes and the stream is written in TUM order (t x y z qx qy qz
    qw); report.json and no stats.jsonl, as in the JAX CLI's chunked
    mode.  The two
    benchmark flags exclude each other."""
    import json

    from superodom_tpu_torch import cli

    assert cli.parse_args(["--synthetic", "1"]).profile == "vlp_16"
    with pytest.raises(SystemExit):
        cli.parse_args(["--synthetic", "1", "--ship", "--parity"])
    out = tmp_path / "run"
    cli.main(["--synthetic", "12", "--chunked", "--high-rate", "--device",
              "cpu", "--out", str(out)])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["config"] == "default"
    assert line["scans"] == 12 and line["device"] == "cpu"
    assert sorted(p.name for p in out.iterdir()) == [
        "report.json", "state_estimation.txt", "trajectory.txt"]
    traj = np.loadtxt(out / "trajectory.txt")
    assert traj.shape == (12, 7) and np.isfinite(traj).all()
    hr = np.loadtxt(out / "state_estimation.txt")
    assert hr.shape[1] == 8 and len(hr) > 20
    assert np.all(np.diff(hr[:, 0]) > 0)
    np.testing.assert_allclose(np.linalg.norm(hr[:, 4:8], axis=1), 1.0,
                               atol=1e-5)


def test_cli_save_map_localize_checkpoint_resume(tmp_path, capsys):
    """The CLI on the CPU: a replay that writes its map (``--save-map``)
    and its state (``--checkpoint``); localization runs against that map
    from ``--init-pose`` and from ``--init-pose-file``, leaving it frozen;
    ``--resume`` from the checkpoint continues from its frame count."""
    import json

    from superodom_tpu.io.pcd import read_pcd as j_read_pcd

    from superodom_tpu_torch import checkpoint, cli
    from superodom_tpu_torch.pipeline import init_state as tp_init_state

    def run(*flags):
        out = tmp_path / f"run{len(list(tmp_path.iterdir()))}"
        cli.main(["--synthetic", "6", "--device", "cpu", "--out", str(out),
                  *flags])
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["scans"] == 6 and np.isfinite(line["ate_rmse_m"])
        return out, line

    m, ck = str(tmp_path / "map.pcd"), str(tmp_path / "state.npz")
    run("--save-map", m, "--checkpoint", ck)
    prior = j_read_pcd(m)
    assert len(prior) > 1000 and np.isfinite(prior).all()
    saved = checkpoint.load_state(ck, cli.config_from_args(
        cli.parse_args(["--synthetic", "6"])), "cpu")
    assert int(saved.frame_count) == 6
    pose_file = tmp_path / "start_pose.txt"
    pose_file.write_text("0.0 0.1 0.0 0.0 0.0 0.02\n")
    # the prior map as localization loads it, before any scan
    cfg = cli.config_from_args(cli.parse_args(["--synthetic", "6",
                                               "--localize", m]))
    loaded = str(tmp_path / "loaded.pcd")
    checkpoint.save_prior_map(loaded, checkpoint.load_prior_map(
        m, cfg, tp_init_state(cfg)))
    for init in (["--init-pose", "0", "0.1", "0", "0", "0", "0.02"],
                 ["--init-pose-file", str(pose_file)]):
        m2 = str(tmp_path / f"after{len(init)}.pcd")
        out, line = run("--localize", m, *init, "--save-map", m2)
        assert line["ate_rmse_m"] < 0.2
        with open(m2, "rb") as f, open(loaded, "rb") as g:
            assert f.read() == g.read()
        traj = np.loadtxt(out / "trajectory.txt")
        assert traj.shape == (6, 7)
    ck2 = str(tmp_path / "resumed.npz")
    run("--resume", ck, "--checkpoint", ck2)
    resumed = checkpoint.load_state(ck2, cli.config_from_args(
        cli.parse_args(["--synthetic", "6"])), "cpu")
    assert int(resumed.frame_count) == 12
