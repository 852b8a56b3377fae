"""The profiling script's device-time accounting (its numbers go into PERF.md)."""

import pytest

from sparse_videogen_tpu_torch.scripts.profile_wan import breakdown, category


@pytest.mark.parametrize("name,cat", [
    ("void (anonymous namespace)::bsa_kernel<128>(...)", "K1 attention (bsa_kernel)"),
    ("svt_rope::rope_kernel(...)", "K2 RoPE (rope_kernel)"),
    ("void (anonymous namespace)::runs_kernel<128>(...)", "K3 run-list attention (runs_kernel)"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, ...>>(...)", "reduce"),
    ("void (anonymous namespace)::kmeans_reduce_kernel(...)", "K5 k-means (kmeans_*_kernel)"),
    ("void (anonymous namespace)::kmeans_assign_kernel<128, 1>(...)", "K5 k-means (kmeans_*_kernel)"),
    ("(anonymous namespace)::kmeans_count_kernel(int const*, float*, int, int)", "K5 k-means (kmeans_*_kernel)"),
    ("void (anonymous namespace)::kmeans_csq_kernel(...)", "K5 k-means (kmeans_*_kernel)"),
    ("void (anonymous namespace)::kmeans_assign_kernel<128>(...)", "K5 k-means (kmeans_*_kernel)"),
    ("(anonymous namespace)::kmeans_scatter_kernel(int const*, int const*, int*, int, int, int, int)",
     "K5 k-means (kmeans_*_kernel)"),
    ("void (anonymous namespace)::kmeans_segsum_kernel<128>(...)", "K5 k-means (kmeans_*_kernel)"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<...>(...)", "sort/scan/gather/scatter (SAP index maps)"),
    ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN", "GEMM (cuBLAS)"),
    ("void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(...)>", "copy/memset/cat"),
    ("Memcpy HtoD (Pageable -> Device)", "copy/memset/cat"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl(...)>", "elementwise"),
])
def test_category(name, cat):
    assert category(name) == cat


def test_breakdown_busy_is_the_union_of_intervals():
    # overlapping [0, 10) and [5, 20), then a gap, then [30, 40) and [41, 42): ns
    ev = [("bsa_kernel", 0, 10_000_000), ("nvjet", 5_000_000, 20_000_000),
          ("direct_copy", 30_000_000, 40_000_000), ("gelu", 41_000_000, 42_000_000)]
    cats, total, busy, span = breakdown(ev)
    assert total == pytest.approx(10 + 15 + 10 + 1)  # ms: summed durations count overlap twice
    assert busy == pytest.approx(20 + 10 + 1)
    assert span == pytest.approx(42)
    assert cats["K1 attention (bsa_kernel)"] == {"ms": pytest.approx(10), "launches": 1}
