"""A CPU stand-in for the card, for the benchmark's tests: the same scene
through the TORCH backend on the CPU, and the fused window of the CUDA
tier (``build_fused_window``), whose kernel wrappers run their plain
versions on CPU tensors."""

SMALL = {"cavity512.window.bf16": {"shape": [16, 16, 16], "steps": 20},
         "cavity512.window.f32": {"shape": [16, 16, 16], "steps": 20},
         "sphere_open.window.f32": {"shape": [48, 24, 24], "steps": 20},
         "sphere_open.train.f32": {"shape": [48, 24, 24], "steps": 2, "trace_iterations": 2}}


class CpuSystem:
    device = "cpu"

    def scene(self, config, cfg, boundaries, policy):
        return config.program_scene(cfg, boundaries, policy, self.device, "TORCH")

    def window(self, stepper, steps):
        from xlb_tpu_torch.kernels.fused_step import build_fused_window

        return build_fused_window(stepper, steps)

    def sync(self):
        pass

    def event(self):
        return type("Done", (), {"synchronize": lambda self: None})()

    def memory_peak(self):
        return 0

    def counters(self):
        from lbm_bench.bench import launch_counters

        return launch_counters("plain_calls")

    def device_info(self, chips):
        return {"platform": "cpu", "kind": "cpu", "count": chips}
