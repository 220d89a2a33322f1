"""Model families of the port: the dense transformer LM (``transformer``),
the recsys models (``recsys``), GIN (``gnn``), the primitives they share
(``common``) and the tree-holding module of the last two
(``tree_module``)."""
