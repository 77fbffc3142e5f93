"""Model building blocks and parameter trees."""
