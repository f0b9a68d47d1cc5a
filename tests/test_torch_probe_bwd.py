"""The backward kernel's probe (acezero_tpu_torch/ops/probe_bwd.py) patches
the kernel's source text into timing variants. These tests run without a
card: every patch applies to the source as it stands, each variant removes
what its name says, and a source the patches no longer fit is refused
rather than probed half-patched."""

import pytest

from acezero_tpu_torch.ops import probe_bwd


@pytest.mark.parametrize("name", sorted(probe_bwd.VARIANTS))
def test_variant_patches_apply(name):
    src = probe_bwd.variant_source(name)
    assert "fused_head_bwd_kernel" in src and 'extern "C"' in src
    if name == "kernel":
        assert src == probe_bwd.SOURCE.read_text()


def test_variants_remove_what_they_name():
    ring_only = probe_bwd.variant_source("ring_only")
    assert "wgmma_m64n256k16<TRANS_B>(acc, da, db" not in ring_only
    assert "for (int j = 0; j < 32; ++j)" not in ring_only
    assert "issue_slab(ring, n + 2" in ring_only  # the ring itself stays
    no_ring = probe_bwd.variant_source("no_ring")
    assert "if (n < STAGES) mbar_wait" in no_ring
    assert "wgmma_m64n256k16<TRANS_B>(acc, da, db" in no_ring
    profile = probe_bwd.variant_source("profile")
    assert profile.count("clock64()") >= 10 and "probe_clocks_read" in profile
    assert probe_bwd.TIMING_ONLY == {"ring_only", "no_ring"}


def test_a_patch_that_no_longer_fits_is_refused():
    src = probe_bwd.SOURCE.read_text().replace("mbar_wait(ring.full", "mbar_wait(ring.full_")
    with pytest.raises(ValueError, match="no longer applies"):
        probe_bwd.variant_source("no_ring", src)
