"""Tree IR, the boosting driver and its variants (GOSS, DART, RF) of
the port."""

from .tree import Tree, TreeArrays
