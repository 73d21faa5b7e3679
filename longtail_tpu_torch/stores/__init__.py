"""Block stores (the port's copies of the JAX package's); the compression
wrapper runs its codecs' match search on a torch device."""
