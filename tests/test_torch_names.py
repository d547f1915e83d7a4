"""The port's top-level names against gofr_tpu's: a service moves to
the port by changing one import (gofr_tpu_torch/__init__.py), so every
name gofr_tpu exports at the top is exported by gofr_tpu_torch too, and
every name only the port exports is named here."""

import inspect

import pytest

import gofr_tpu
import gofr_tpu_torch

# the port's own entry points beside gofr_tpu's: the serving routes'
# installers and the device resolver (``device="cuda"`` by default)
PORT_ONLY = {"install_embeddings", "install_generate", "resolve_device"}


def test_the_two_packages_export_the_same_names_but_the_port_s_own():
    assert set(gofr_tpu_torch.__all__) - set(gofr_tpu.__all__) == PORT_ONLY
    assert set(gofr_tpu.__all__) - set(gofr_tpu_torch.__all__) == set()
    assert len(gofr_tpu_torch.__all__) == len(set(gofr_tpu_torch.__all__))
    for name in gofr_tpu_torch.__all__:
        assert hasattr(gofr_tpu_torch, name), name


@pytest.mark.parametrize("name", sorted(set(gofr_tpu.__all__)
                                        - {"__version__", "FRAMEWORK"}))
def test_each_shared_name_is_the_same_kind_of_thing(name):
    """A class is a class (an error the same kind of HTTP error, with the
    same status), a function a function, in the port's own module."""
    ours, theirs = getattr(gofr_tpu_torch, name), getattr(gofr_tpu, name)
    assert inspect.isclass(ours) == inspect.isclass(theirs), name
    assert callable(ours) == callable(theirs), name
    assert ours.__module__.split(".")[0] == "gofr_tpu_torch", name
    if inspect.isclass(theirs) and issubclass(theirs, gofr_tpu.GofrError):
        assert issubclass(ours, gofr_tpu_torch.GofrError)
        assert issubclass(ours, gofr_tpu_torch.HTTPError) == issubclass(
            theirs, gofr_tpu.HTTPError)
        if issubclass(theirs, gofr_tpu.HTTPError):
            assert getattr(ours, "status", None) == getattr(theirs, "status",
                                                            None), name


def test_the_docstring_s_import_works():
    from gofr_tpu_torch import Context, Deadline, HTTPError, MapConfig

    cfg = MapConfig({"A": "1"})
    assert cfg.get("A") == "1" and cfg.get_or_default("B", "2") == "2"
    assert issubclass(HTTPError, Exception)
    assert Context is gofr_tpu_torch.context.Context
    assert Deadline is gofr_tpu_torch.resilience.Deadline


def test_config_is_a_protocol_both_readers_meet():
    """``Config`` is the port's own protocol (gofr_tpu's is a
    ``typing.Protocol`` too): EnvConfig and MapConfig both have its
    methods."""
    from typing import Protocol

    assert Protocol in gofr_tpu_torch.Config.__mro__
    for reader in (gofr_tpu_torch.EnvConfig(), gofr_tpu_torch.MapConfig({})):
        for method in ("get", "get_or_default"):
            assert callable(getattr(reader, method))
