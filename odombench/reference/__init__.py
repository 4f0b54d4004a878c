"""The plain reference of one odometry step, frozen for the benchmark.

A copy of the port's plain path (``superodom_tpu_torch`` as of commit
95bb3fc, unchanged up to the commit that added the benchmark: ``geometry``,
``frontend``, ``inertial``, ``mapstate``, ``registration``, ``pipeline``,
``config``, ``ops.voxel``, ``ops.eigh3``, ``ops.smallsolve``) with every
hand kernel's dispatch replaced by its plain version (``*_reference``),
every ``ops.invariant`` op by the plain torch op, and no vmap: plain
PyTorch, one instance, no kernels. The port's CPU tests hold that plain path
to the JAX package at small sizes with these paths' settings
(``tests/test_torch_paths.py`` ``test_one_step_matches_jax[parity|vlp16]``,
``tests/test_torch_pipeline.py`` ``test_one_step_matches_jax`` and
``test_replay_tracks_like_jax``, ``tests/test_torch_parallel.py``
``test_batched_step_matches_jax``), not at the cells' full widths.
``inputs`` works the step's inputs out again from the raw sequence (the IMU
buffer's chain and windows, the host stride). Nothing here imports the
program; the program's later changes are judged against this copy.
"""
