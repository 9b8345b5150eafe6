"""One-electron integrals for the edge features: basis sets, the C++
engine (`engine`) and its plain numpy version (`md`)."""
