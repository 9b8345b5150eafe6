"""The JAX package's evaluation and measurement scripts (`scripts/`), one
module each under the same name, run as

    python -m x2gnn_tpu_torch.scripts.<name> [--device cpu] ...

- `aid_cv`: k-fold cross-validation on an AID-format xyz against a
  composition baseline;
- `featurize_aid`: resumable featurizing of an xyz file in chunks into the
  cache `load_dataset` reads;
- `merge_chunks`: the first N molecules of a chunked build as one cache;
- `profile_step`: the training step split by ablation;
- `bench_infer`: serving molecules/s through the Predictor;
- `debug_ep_cost`: the edge-partitioned step's pieces timed at world size 1;
- `bench_scaling`: weak scaling of the single, DP, EP and DP x EP steps;
- `pack_ab`: packed against fixed budgets at matched optimizer steps;
- `pipeline_demo`: epochs of a geometry-only cache streamed from the host.

Each keeps its JAX twin's flags, printed keys and file names, runs on the
card unless given `--device cpu` (a missing card raises), and imports
neither JAX nor the JAX package.
"""
