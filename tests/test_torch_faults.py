"""chip_smoke.py's planted faults against the sources they patch, on the
CPU: each entry of ``chip_smoke.FAULTS`` names a line that occurs exactly
once in its file under ``protein_clip_tpu_torch/csrc/``, so that a fault
whose kernel source moved or changed fails here, not in a build on the
card. The same for the variant builds of ``tools/probe_attention_f32.py``."""

import pytest

import chip_smoke
from protein_clip_tpu_torch.kernels import build
from protein_clip_tpu_torch.tools import probe_attention_f32


@pytest.mark.parametrize("name", sorted(chip_smoke.FAULTS))
def test_fault_line_occurs_once_in_its_source(name):
    header, line, patched, kernels = chip_smoke.FAULTS[name]
    assert (build.CSRC_DIR / header).read_text().count(line) == 1
    assert patched != line
    assert all((build.CSRC_DIR / f"{kernel}.cu").exists() for kernel in kernels)


@pytest.mark.parametrize("name", sorted(probe_attention_f32.VARIANTS))
def test_probe_variant_lines_occur_once_in_their_sources(name):
    for file, line, patched in probe_attention_f32.VARIANTS[name]:
        assert (build.CSRC_DIR / file).read_text().count(line) == 1, line
        assert patched != line
