"""Model families of the port: the dense transformer LM (``transformer``)
and the primitives it shares (``common``)."""
