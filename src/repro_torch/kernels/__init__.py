"""The port's hand-written kernels and their wrappers."""


def launch_counters() -> list:
    """(holder, key) of every kernel launch counter the wrappers bump: each
    wrapper's ``launches``, each entry of ``ovsf_gemm``'s per-storage and
    per-kernel counts and of ``ovsf_decompress``'s per-layout counts (read
    anew: ``ovsf_gemm.reset_launches`` replaces the dicts) and
    ``flash_decode_attn``'s unmasked launches. A new kernel's wrapper adds
    its counter here."""
    from repro_torch.kernels import decode_attn, fwht, ovsf_gemm
    G = ovsf_gemm
    out = [(w, "launches") for w in (
        G.ovsf_gemm, G.ovsf_decompress, fwht.fwht,
        decode_attn.flash_decode_attn, decode_attn.paged_flash_decode)]
    for d in (G.ovsf_gemm.launches_by_alpha, G.ovsf_gemm.launches_by_kernel,
              G.ovsf_decompress.launches_by_layout):
        out += [(d, k) for k in d]
    return out + [(decode_attn.flash_decode_attn, "launches_unmasked")]
