"""AO-40 FEC decode of the port: Viterbi(k=7, r=1/2) + 2x shortened
RS(255,223) and the re-encode check."""
