"""The port's profiling tools' host-side pieces on the CPU.

``profile_train`` sums the device time of the port's own kernels by
matching the profiler's kernel names against the ``__global__`` functions
of ``vipers_torch/csrc``; this holds that list to the kernels the sources
define, so a renamed or added kernel is not silently left out of the sum.
"""

from vipers_torch.tools.profile_train import port_kernel_pattern, port_kernels


def test_profile_train_finds_every_port_kernel():
    """Every kernel of the sources, the flash backward's row pass, dk/dv
    and dq kernels and the forward's bf16 and f32 tiles among them, and
    nothing else; the name pattern matches a profiler row of each and not
    of a neighbour with a longer name."""
    names = port_kernels()
    assert names == {"attention_bwd_kernel", "attention_train_fwd_kernel", "flash_bwd_dkv",
                     "flash_bwd_dkv_f32", "flash_bwd_dq", "flash_bwd_dq_f32", "flash_bwd_rows",
                     "fused_ln_dense_gelu_kernel", "fwd_bf16", "fwd_f32"}
    own = port_kernel_pattern()
    assert own.search("(anonymous namespace)::flash_bwd_dq(CUtensorMap_st, float const*)")
    assert own.search("void attn_tile::hopper::fwd_f32<(anonymous namespace)::FlashLayout<float> >"
                      "(CUtensorMap_st)")
    assert own.search("void attn_bwd::attention_bwd_kernel<0, true>(CUtensorMap_st)")
    assert not own.search("void at::native::vectorized_elementwise_kernel<4, at::native::add>")
    assert not own.search("(anonymous namespace)::flash_bwd_dq_f64(float const*)")
