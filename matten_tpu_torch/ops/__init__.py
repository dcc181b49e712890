"""O(3) ops on torch tensors: tensor-product plans, spherical harmonics,
segment reductions and the Cartesian change of basis."""
