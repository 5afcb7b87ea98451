"""The port's command lines take the JAX package's options.

For each module of ``videocad_tpu/cli/`` that builds a parser, the options
of its parser are read by calling ``main`` until it parses (the parsers
are built inside ``main``), and the port's module of the same name is held
to the same option names with the same destinations and defaults. Options
only the port has (``--device``, ``--jax_params``, ...) are allowed. One
JAX option has no counterpart on purpose: ``cli/train.py
--dropout_rng_impl`` picks the TPU's generator for dropout masks, which
the port draws from Philox (ROADMAP.md, queue 3).

A serving command line in the JAX package's form then loads a trainer
checkpoint of the port on the CPU.
"""

import argparse
import importlib
import json
import os
import pkgutil

import pytest
import torch

import videocad_tpu.cli as jax_cli
from tests.helpers import TINY_CONFIG
from videocad_tpu_torch.cli import serve as port_serve
from videocad_tpu_torch.models import create_model
from videocad_tpu_torch.train import state as port_state
from videocad_tpu_torch.train.checkpoint import CheckpointHandler

NO_COUNTERPART = {"train": {"--dropout_rng_impl"}}
MODULES = sorted(m.name for m in pkgutil.iter_modules(jax_cli.__path__))


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__("parsed")
        self.parser = parser


def _options(package, name, monkeypatch):
    """{option string: (dest, default)} of ``package.cli.<name>``'s
    parser, or None where the module builds none."""
    module = importlib.import_module(f"{package}.cli.{name}")
    if not hasattr(module, "main"):
        return None

    def caught(parser, *args, **kwargs):
        raise _Parsed(parser)

    with monkeypatch.context() as patch:
        patch.setattr(argparse.ArgumentParser, "parse_args", caught)
        with pytest.raises(_Parsed) as parsed:
            module.main([])
    return {option: (action.dest, action.default)
            for action in parsed.value.parser._actions
            for option in action.option_strings if option != "-h"
            and option != "--help"}


@pytest.mark.parametrize("name", MODULES)
def test_port_cli_takes_the_jax_options_and_defaults(name, monkeypatch):
    want = _options("videocad_tpu", name, monkeypatch)
    got = _options("videocad_tpu_torch", name, monkeypatch)
    if want is None:
        assert got is None, f"the JAX cli/{name}.py has no parser"
        return
    assert got is not None, f"the port's cli/{name}.py has no parser"
    exempt = NO_COUNTERPART.get(name, set())
    missing = sorted(set(want) - set(got) - exempt)
    assert not missing, f"cli/{name}.py: the port lacks {missing}"
    differ = {option: (want[option], got[option]) for option in want
              if option not in exempt and got[option] != want[option]}
    assert not differ, (f"cli/{name}.py: (dest, default) of the JAX package "
                        f"and of the port differ: {differ}")
    for option in exempt:
        assert option in want, f"{option} is gone from the JAX cli/{name}.py"


def test_serve_cli_loads_a_checkpoint_named_as_the_jax_package_names_it(
        tmp_path):
    """--checkpoint_folder <experiment> --checkpoint_name epoch_2
    --checkpoint_dir <dir>: the weights of <dir>/<experiment>/epoch_2."""
    config = dict(TINY_CONFIG, num_decoder_layers=1)
    model_config = tmp_path / "model.json"
    model_config.write_text(json.dumps({"tiny": config}))
    trained = create_model(config, generator=torch.Generator().manual_seed(9))
    handler = CheckpointHandler("exp", str(tmp_path / "ckpt"))
    for epoch in (0, 1):
        with torch.no_grad():
            for param in trained.parameters():
                param.add_(0.25)
        handler.save(port_state.create_train_state(
            dict(trained.named_parameters()), {"lr": 1e-3}), epoch, 0.0)
    args = port_serve.parse_args([
        "--device", "cpu", "--lanes", "2", "--seq_len", "8",
        "--model_config", str(model_config), "--model_name", "tiny",
        "--checkpoint_folder", "exp", "--checkpoint_name", "epoch_2",
        "--checkpoint_dir", str(tmp_path / "ckpt")])
    engine = port_serve.build_engine(args)
    try:
        saved = torch.load(os.path.join(handler.base, "epoch_2", "state.pt"),
                           weights_only=True)["params"]
        first = torch.load(os.path.join(handler.base, "epoch_1", "state.pt"),
                           weights_only=True)["params"]
        for name, value in engine.model.state_dict().items():
            assert torch.equal(value, saved[name]), name
        assert any(not torch.equal(saved[k], first[k]) for k in saved)
    finally:
        engine.stop()
    # The defaults: best_model under checkpoints/ of the working directory.
    args = port_serve.parse_args(["--checkpoint_folder", "exp"])
    assert (args.checkpoint_dir, args.checkpoint_name) == ("checkpoints",
                                                           "best_model")
