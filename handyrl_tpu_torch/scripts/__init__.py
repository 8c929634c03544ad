"""Command-line tools of the port, each run as
``python -m handyrl_tpu_torch.scripts.<name>`` from a run directory
(``config.yaml`` and ``models/`` in the working directory), with the
arguments of its twin under the repository's ``scripts/``:

  aux_swa          <first_epoch> <last_epoch> [stride]
  export_model     [model.ckpt] [out.npz]
  make_onnx_model  [model.ckpt] [out.onnx] [--device DEV]
  plot_metrics     <train.log | metrics.jsonl> [out_prefix]
  perf_ledger      <run_dir | bench.json>... [--check] [--ledger PATH]
  export_trace     <run_dir> [out.json]
  attribution_report <run_dir> [--top N] [--baseline OTHER_RUN]
"""
