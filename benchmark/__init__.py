"""The benchmark of ``spt_tpu_torch``: one command runs one cell
(``run.py``); see PERF.md at the repository's root."""
