"""The port's command-line tools: the twins of the repo's ``tools/*.py``.

Each module keeps the JAX tool's name, flags, defaults, JSON record keys
and printed lines, and runs as ``python -m deepgo_tpu_torch.tools.<name>``
(``main(argv=None)``). Every tool that touches a net takes ``--device``
(``cuda`` by default; without CUDA it raises, it never moves to the CPU).
Default ``--out`` files land under ``runs/torch_tools/``.

  corpus and accuracy    ``make_corpus``, ``make_selfplay_corpus``,
                         ``subset_split``, ``accuracy_curve``
  the port's levers      ``symmetry_eval`` (the sym kernel's users),
                         ``feed_bench`` (the streamed train path)
  the rest               ``debug_twoply``, ``convert_torch_dataset`` (with
                         its ``t7reader``), ``make_notebook``
"""

OUT_DIR = "runs/torch_tools"
