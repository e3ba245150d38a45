"""Host graph containers and seeded generators."""
