"""The kernel build's cache key, on the CPU (nvcc is never run here)."""

import shutil
import subprocess

import pytest

from dropout_hamiltonian_montecarlo_tpu_torch.ops import cuda_build as cb


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    def no_compiler(*args, **kwargs):
        raise AssertionError(f"the digest must not run a compiler: {args}")

    monkeypatch.setattr(subprocess, "run", no_compiler)
    src = tmp_path / "csrc"
    shutil.copytree(cb.CSRC_DIR, src)
    return src


def test_library_name_follows_every_source_and_flag(csrc, monkeypatch):
    name = "softmax_glm"
    base = cb.library_path(name, csrc)
    assert base.name == f"lib{name}_{cb.build_digest(name, csrc)}.so"
    assert cb.library_path(name, csrc) == base            # stable
    assert cb.build_digest(name, cb.CSRC_DIR) == cb.build_digest(name, csrc)

    header = csrc / "wgmma.cuh"
    original = header.read_bytes()
    header.write_bytes(original + b"\n")                  # an edited header rebuilds
    assert cb.library_path(name, csrc) != base
    header.write_bytes(original)
    assert cb.library_path(name, csrc) == base

    (csrc / "extra.cuh").write_text("#pragma once\n")     # so does a new file
    assert cb.library_path(name, csrc) != base
    (csrc / "extra.cuh").unlink()

    monkeypatch.setattr(cb, "BUILD_FLAGS", cb.BUILD_FLAGS + ["-DDHMC_TEST"])
    assert cb.library_path(name, csrc) != base            # and so do the flags
