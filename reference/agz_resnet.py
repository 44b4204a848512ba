"""AlphaGo Zero's dual-head residual network, its loss and momentum SGD, in
plain float32 PyTorch: the reference that the port's tests hold
``models/resnet.py`` and ``training/steps.py`` to.

One implementation serves the tests and the benchmark, whose files carry
their own reference: it is ``benchmark/reference/agz.py``, written from
Silver et al. 2017 (Nature 550:354), Methods, with each departure from the
paper in its docstring. It imports nothing of ``deepgo_tpu_torch``,
``deepgo_tpu`` or ``jax``, and turns TF32 off before it steps.
"""

from benchmark.reference.agz import (  # noqa: F401
    forward, fresh_stats, l2_names, leaf_shapes, loss, sgd_steps)
