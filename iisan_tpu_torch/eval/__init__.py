"""Full-catalogue item tables and HR@K / nDCG@K evaluation."""
