from .tree import (  # noqa: F401
    softmax_np,
    stack_time_player,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_map_leaves,
    tree_stack,
    tree_structure,
    tree_unflatten,
)
