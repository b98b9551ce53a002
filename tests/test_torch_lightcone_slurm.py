"""scripts/lightcone_slurm_torch.sbatch, the SLURM array twin of
scripts/lightcone_slurm.sbatch for the port: its command line, with the
environment variables expanded as bash would, is one that
scripts/create_lightcone_torch.py's parser accepts, and it passes the JAX
script's flags from the same variables, one GPU a task.
"""
import importlib.util
import re
import shlex
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent

TWIN = REPO / "scripts" / "lightcone_slurm_torch.sbatch"
JAX_SCRIPT = REPO / "scripts" / "lightcone_slurm.sbatch"
ENV = {"SLURM_ARRAY_TASK_ID": "74", "CVAE_PATH": "trained_models/CVAE/x",
       "SLICS_BASE_PATH": "/data/slics"}


def _command(path, env):
    """The script's python command (continuation lines joined), with
    ${VAR}, ${VAR:-default} and ${VAR:?message} expanded from ``env``."""
    text = path.read_text().replace("\\\n", " ")
    line = next(l for l in text.splitlines() if l.startswith("python "))
    env = dict(env, LOS=env["SLURM_ARRAY_TASK_ID"])

    def expand(m):
        name, op, arg = m.group(1), m.group(2), m.group(3)
        if name in env:
            return env[name]
        if op == ":-":
            return arg
        raise KeyError(f"{name} unset: {arg}")

    return shlex.split(re.sub(r"\$\{(\w+)(?:(:[-?])([^}]*))?\}", expand,
                              line))


def _parser():
    spec = importlib.util.spec_from_file_location(
        "create_lightcone_torch",
        REPO / "scripts" / "create_lightcone_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.parse_args


@pytest.mark.parametrize("env", [ENV, dict(ENV, MODEL_TYPE="CGAN",
                                           OUTPUT_BASE="out/y")],
                         ids=["defaults", "cgan_and_output_base"])
def test_every_flag_is_accepted_by_the_cli(env):
    cmd = _command(TWIN, env)
    assert cmd[:2] == ["python", "scripts/create_lightcone_torch.py"]
    args = _parser()(cmd[2:])
    assert args.SLICS_LOS == "74"
    assert args.CVAE_path == env["CVAE_PATH"]
    assert args.SLICS_base_path == env["SLICS_BASE_PATH"]
    assert args.model_type == env.get("MODEL_TYPE", "CVAE")
    assert args.output_file == env.get("OUTPUT_BASE", "y_map") + "_LOS74"


def test_the_twin_passes_the_jax_scripts_flags_on_one_gpu_a_task():
    twin, jax = (_command(p, ENV) for p in (TWIN, JAX_SCRIPT))
    assert twin[1] == "scripts/create_lightcone_torch.py"
    assert jax[1] == "scripts/create_lightcone.py"
    assert twin[2:] == jax[2:]
    directives = [l for l in TWIN.read_text().splitlines()
                  if l.startswith("#SBATCH")]
    assert "#SBATCH --gres=gpu:1" in directives
    jax_directives = [l for l in JAX_SCRIPT.read_text().splitlines()
                      if l.startswith("#SBATCH")]
    for d in jax_directives:
        if "--job-name" not in d and "--output" not in d:
            assert d in directives
    with pytest.raises(KeyError, match="CVAE_PATH"):
        _command(TWIN, {k: v for k, v in ENV.items() if k != "CVAE_PATH"})
