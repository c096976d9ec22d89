"""The plain reference of the benchmark: LWE decryption with the secret key
the benchmark made, and the plaintext results of each kind of request.
numpy only; it imports nothing of sgfhe_tpu_torch or of the JAX package,
and takes nothing the port made but the answers it judges."""
