"""Host graph containers and layouts (CSR, BELL forest, ELL slab), and
seeded generators."""
