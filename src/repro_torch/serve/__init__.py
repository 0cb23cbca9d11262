from repro_torch.serve.engine import ServeEngine, build_decode_step, build_prefill_step

__all__ = ["build_prefill_step", "build_decode_step", "ServeEngine"]
