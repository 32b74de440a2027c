"""Entry-point regression: entry() traces, dryrun_multichip(8) runs."""

import sys
from pathlib import Path

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def test_entry_traces():
    import __graft_entry__ as g

    fn, args = g.entry()
    shapes = jax.eval_shape(fn, *args)  # full trace, no compute
    refined, flow = shapes
    assert refined.shape == (32768, 3)
    assert flow.shape == (32768, 3)


def test_dryrun_multichip_8():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_dryrun_multichip_driver_condition():
    """Driver regression: jax already initialized with ONE device.

    A caller that already initialized jax with one device cannot get the
    in-process ``xla_force_host_platform_device_count`` mesh; the entry
    point must self-provision the virtual mesh in a subprocess. Simulate
    that exact condition in a clean interpreter with no device-count flag.
    """
    import os
    import subprocess

    repo = str(Path(__file__).resolve().parent.parent)
    env = dict(os.environ)
    env["XLA_FLAGS"] = " ".join(
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    env.pop("_HIMO_DRYRUN_SUBPROC", None)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    code = (
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "assert len(jax.devices()) < 8, 'precondition: single-device init'\n"
        "import __graft_entry__\n"
        "__graft_entry__.dryrun_multichip(8)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        capture_output=True,
        text=True,
        timeout=600,
    )
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    assert "dryrun_multichip(8)" in out.stdout and "OK" in out.stdout
