"""paddle_tpu_torch.tools — the port's own operator tools: the lints of
flight bundles and fleet journals (``flight_inspect``) and the seeded
chaos harness over the serving fleet (``chaos_serving``). They import
nothing of the repo's top-level ``tools/`` directory."""
