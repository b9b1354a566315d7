"""The import guard compares whole top-level module names."""

from benchmark import guard


def test_the_port_passes_and_the_jax_package_fails():
    assert guard.forbidden_loaded(["mrg_slam_tpu_torch",
                                   "mrg_slam_tpu_torch.ops.knn",
                                   "numpy", "jax_like", "jaxtyping"]) == []
    assert guard.forbidden_loaded(["mrg_slam_tpu.ops.knn"]) == [
        "mrg_slam_tpu"]
    assert guard.forbidden_loaded(["jax", "jaxlib.xla_client", "flax.linen",
                                   "torch"]) == ["flax", "jax", "jaxlib"]


def test_this_process_holds_none_of_them_after_the_harness_imports():
    import subprocess
    import sys
    code = ("import benchmark.run, benchmark.reference.judge, sys;"
            "from benchmark import guard;"
            "print(guard.forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=__file__.rsplit("/benchmark/", 1)[0])
    assert out.stdout.strip() == "[]"
