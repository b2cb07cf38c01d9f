"""Plain NumPy references: nothing here imports jax, the JAX package or
anything of spark_rapids_jni_tpu_torch, and nothing takes the program's
outputs except to judge them."""
