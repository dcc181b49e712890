"""Canonical field names of the graph data dict.

The framework's universal data representation is a flat
``{field_name: jnp.ndarray}`` dict (a JAX pytree), mirroring the reference's
DataKey registry (data/_key.py:14-49) with additional static-shape padding
masks required on TPU.
"""

# --- geometry ---------------------------------------------------------------
POSITIONS = "pos"  # [N, 3] cartesian coordinates
EDGE_INDEX = "edge_index"  # [2, E] int32; row 0 = source/center, row 1 = target
EDGE_CELL_SHIFT = "edge_cell_shift"  # [E, 3] periodic image shifts (float)
CELL = "cell"  # [G, 3, 3] lattice vectors as rows (ASE convention)
NUM_NEIGH = "num_neigh"  # [N] float neighbor counts
BATCH = "batch"  # [N] int32 graph id of each node

# --- species ----------------------------------------------------------------
ATOMIC_NUMBERS = "atomic_numbers"  # [N] int32
SPECIES_INDEX = "species_index"  # [N] int32, 0..num_species-1

# --- learned fields ---------------------------------------------------------
NODE_FEATURES = "node_features"
NODE_ATTRS = "node_attrs"
EDGE_ATTRS = "edge_attrs"
EDGE_EMBEDDING = "edge_embedding"
EDGE_VECTORS = "edge_vectors"
EDGE_LENGTH = "edge_length"
ATOM_FEATS = "atom_feats"  # [N, F] precomputed per-atom features
GLOBAL_FEATS = "global_feats"  # [G, F] precomputed per-crystal features

POS_FULL = "pos_full"  # [N_total, 3] halo-gathered positions (node-sharded mode)

# --- padding masks (TPU static shapes; no reference counterpart) ------------
NODE_MASK = "node_mask"  # [N] bool, True = real node
EDGE_MASK = "edge_mask"  # [E] bool, True = real edge
GRAPH_MASK = "graph_mask"  # [G] bool, True = real graph

# --- chunk-aligned edge layout (fused-kernel metadata; host-built) ----------
# Present only when collation ran with chunk alignment (data/graph.py):
# the dst-sorted edge list is grouped so every EDGE_BLOCK of edges targets
# one NODE_CHUNK of nodes, enabling the node-chunked Pallas accumulator
# (kernels/fused_conv.py) at any batch size.
EDGE_DST_CHUNK = "edge_dst_chunk"  # [E/B] int32 block -> dst node-chunk owner
EDGE_SRC_PERM = "edge_src_perm"  # [E] int32 src-sorted edge permutation
EDGE_SRC_CHUNK = "edge_src_chunk"  # [E/B] int32 block -> src node-chunk owner
# shape-encoded static geometry: length == number of node chunks, so the
# kernel derives node_chunk = N // len(tag) and edge_block = E // len(owner)
EDGE_CHUNK_TAG = "edge_chunk_tag"  # [num_chunks] int8 zeros

# --- misc -------------------------------------------------------------------
ATOM_SELECTOR = "atom_selector"  # [N] bool mask for per-atom targets
