"""The forward kernel's probe (acezero_tpu_torch/ops/probe_fwd.py) patches
the kernel's source text into timing variants. These tests run without a
card: every patch applies to the source as it stands, each variant removes
or changes what its name says, and a source the patches no longer fit is
refused rather than probed half-patched."""

import pytest

from acezero_tpu_torch.ops import probe_bwd, probe_fwd


@pytest.mark.parametrize("name", sorted(probe_fwd.VARIANTS))
def test_variant_patches_apply(name):
    src = probe_fwd.variant_source(name)
    assert "fused_head_fwd_kernel" in src and 'extern "C"' in src
    if name in ("kernel", f"ring{probe_fwd.RING_SLABS}"):
        assert src == probe_fwd.SOURCE.read_text()


def test_variants_remove_what_they_name():
    ring_only = probe_fwd.variant_source("ring_only")
    assert "wgmma_m64n256k16<1>(acc, da, db" not in ring_only
    assert "for (int j = 0; j < 32; ++j)" not in ring_only
    assert "issue_slab(ring, n - 1 + STAGES" in ring_only  # the ring itself stays
    no_ring = probe_fwd.variant_source("no_ring")
    assert "if (n < STAGES) mbar_wait" in no_ring
    assert "if (false) issue_slab(ring, n - 1 + STAGES" in no_ring
    assert "wgmma_m64n256k16<1>(acc, da, db" in no_ring
    profile = probe_fwd.variant_source("profile")
    assert profile.count("clock64()") >= 10 and "probe_clocks_read" in profile
    for slabs in (3, 4, 5):
        assert f"constexpr int STAGES = {slabs};" in probe_fwd.variant_source(f"ring{slabs}")
    assert "const int grid = tiles;" in probe_fwd.variant_source("grid_per_tile")
    boxes8 = probe_fwd.variant_source("w_boxes8")
    assert "atom_map(enc, &w_map" not in boxes8 and "tma_load_4d" not in boxes8
    assert probe_fwd.TIMING_ONLY == {"ring_only", "no_ring"}


def test_a_patch_that_no_longer_fits_is_refused():
    src = probe_fwd.SOURCE.read_text().replace("mbar_wait(ring.full", "mbar_wait(ring.full_")
    with pytest.raises(ValueError, match="no longer applies"):
        probe_fwd.variant_source("no_ring", src)


def test_the_probes_share_their_machinery():
    assert probe_fwd.apply_patches is probe_bwd.apply_patches
    assert probe_fwd.probe_main is probe_bwd.probe_main
