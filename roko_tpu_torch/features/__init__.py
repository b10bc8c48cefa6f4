"""Feature extraction on the host: FASTA + BAM -> pileup -> 200x90 windows
(and truth labels for training), region by region. No module here imports
torch: region workers may be separate processes."""
