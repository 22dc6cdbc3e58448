"""The port's command-line entry points (`stf_tpu/cli/`):
`python -m stf_tpu_torch.cli.eval_model`, `.rd_compare` and
`.prime_cache`."""
