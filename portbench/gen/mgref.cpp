// Frozen copy of native/mgref.cpp (data_prep and comb build the benchmark's
// multi-genome worlds), kept with the benchmark so its worlds never change
// with the program's native code.
//
// mg-ref: multi-genome construction toolchain (data_prep | comb | sam_pad).
//
// A fresh C++17 implementation with the reference toolchain's exact file
// surface (mg-ref/data_prep.cpp, comb.cpp, sam_pad.cpp):
//
//   data_prep [-c] <in1.vcf> ...      VCF -> mg-ref-output/{SNP,INDEL}.extract.chr*.data
//   comb [-w INT] [-i INT] [-a INT] <ref.fasta> <ref_w_snp.fasta>
//        <ref_w_snp_and_bubble.fasta> <bubble.data>
//   sam_pad <bubble.data> <in.sam> <out.sam>
//
// One multi-call binary: dispatches on basename(argv[0]) or on argv[1].
// Unlike the reference it streams chromosomes into growable buffers instead
// of a fixed 1 GB allocation, but every output byte (including the 60-column
// wrapping behavior of comb.cpp:148-160 and the genotype-column allele
// counting of data_prep.cpp:99-102) matches the reference tools.

#include <sys/stat.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <vector>

namespace {

// ----------------------------------------------------------------- alphabet

// IUPAC char for a 4-bit base mask (bit 8=A, 4=C, 2=G, 1=T), mask 0 = '$'.
const char kMaskChar[16] = {'$', 'T', 'G', 'K', 'C', 'Y', 'S', 'B',
                            'A', 'W', 'R', 'D', 'M', 'H', 'V', 'N'};

// mask of bases denoted by an IUPAC character (case-insensitive); 0 if none.
int char_mask(char c) {
  switch (std::toupper(static_cast<unsigned char>(c))) {
    case 'A': return 8;  case 'C': return 4;  case 'G': return 2;
    case 'T': return 1;  case 'M': return 12; case 'R': return 10;
    case 'W': return 9;  case 'S': return 6;  case 'Y': return 5;
    case 'K': return 3;  case 'V': return 14; case 'H': return 13;
    case 'D': return 11; case 'B': return 7;  case 'N': return 15;
    default:  return 0;
  }
}

// ---------------------------------------------------------------- data_prep

struct ExtractWriter {
  // Per-chromosome extract files under mg-ref-output/ (data_prep.cpp:105-137):
  // truncated on first touch when -c is given and the chromosome is new,
  // appended otherwise.
  bool clear;
  std::set<std::string> seen;  // chromosomes already (re)created this run

  std::ofstream open(const std::string& kind, const std::string& chr) {
    // the reference binary assumes the caller pre-made this directory and
    // silently writes nothing otherwise (data_prep.cpp:105-137); create it
    ::mkdir("mg-ref-output", 0755);
    std::string path = "mg-ref-output/" + kind + ".extract.chr" + chr + ".data";
    bool fresh = clear && !seen.count(kind + ":" + chr);
    seen.insert(kind + ":" + chr);
    return std::ofstream(path, fresh ? std::ios::out
                                     : (std::ios::out | std::ios::app));
  }
};

int run_data_prep(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr,
                 "Usage:   data_prep [option] <input1.vcf> <input2.vcf> ...\n"
                 "Option:  -c  clear all SNP/INDEL extract files first\n");
    return 1;
  }
  int argi = 1;
  ExtractWriter wr{false, {}};
  if (std::strcmp(argv[argi], "-c") == 0) {
    wr.clear = true;
    ++argi;
  }

  for (; argi < argc; ++argi) {
    std::ifstream vcf(argv[argi]);
    if (!vcf) {
      std::fprintf(stderr, "data_prep: cannot open %s\n", argv[argi]);
      return 1;
    }
    std::cout << argv[argi] << std::endl;

    std::string line;
    // skip ## meta lines; the first non-## line is the #CHROM header
    while (std::getline(vcf, line)) {
      if (!(line.size() > 1 && line[0] == '#' && line[1] == '#')) break;
    }

    std::string cur_chr;
    std::ofstream snp, indel;
    std::vector<std::string> f;
    while (std::getline(vcf, line)) {
      f.clear();
      size_t start = 0;
      while (true) {
        size_t tab = line.find('\t', start);
        f.push_back(line.substr(start, tab - start));
        if (tab == std::string::npos) break;
        start = tab + 1;
      }
      if (f.size() < 8) continue;
      const std::string& chr = f[0];
      const std::string& pos = f[1];
      const std::string& ref = f[3];
      const std::string& alt = f[4];
      const std::string& info = f[7];

      // sample columns: count samples carrying a '1' allele in either
      // haplotype position ("1|0", "0/1", ... — data_prep.cpp:99-102)
      long long occ = 0;
      for (size_t i = 9; i < f.size(); ++i) {
        const std::string& a = f[i];
        if ((!a.empty() && a[0] == '1') || (a.size() > 2 && a[2] == '1'))
          ++occ;
      }

      if (info.find("VT=SNP") == std::string::npos &&
          info.find("VT=INDEL") == std::string::npos)
        continue;

      if (chr != cur_chr) {
        snp = wr.open("SNP", chr);
        indel = wr.open("INDEL", chr);
        cur_chr = chr;
      }

      // multi-allelic ALTs are split into independent records
      std::stringstream alts(alt);
      std::string a;
      while (std::getline(alts, a, ',')) {
        if (ref.size() == 1 && a.size() == 1 && a[0] != '.') {
          snp << pos << "\t" << ref << "\t" << a << "\t" << occ << "\n";
        } else if (ref.size() != a.size() ||
                   (ref.size() == 1 && a.size() == 1 && a[0] == '.')) {
          indel << pos << "\t" << ref << "\t" << a << "\t" << occ << "\n";
        }
      }
    }
  }
  return 0;
}

// --------------------------------------------------------------------- comb

struct CombPars {
  long long window = 124;
  long long min_occ = 0, max_occ = 0;
  bool has_min = false, has_max = false;
};

// Write seq (1-based semantics: chars [0, n)) wrapped at 60 columns with the
// reference's exact newline placement (comb.cpp:148-160).
void write_wrapped(std::ostream& out, const std::string& seq) {
  size_t n = seq.size();
  for (size_t i = 1; i <= n; ++i) {
    out << seq[i - 1];
    if (i % 60 == 0) out << "\n";
  }
  if (n % 60) out << "\n";
}

struct FastaStream {
  // Iterate (header, sequence) records of a FASTA file.
  std::ifstream in;
  std::string pending;  // lookahead header line
  bool ok = false;

  explicit FastaStream(const std::string& path) : in(path) {
    std::string line;
    while (std::getline(in, line)) {
      if (!line.empty() && line[0] == '>') {
        pending = line;
        ok = true;
        break;
      }
    }
  }
  bool next(std::string* header, std::string* seq) {
    if (!ok) return false;
    *header = pending;
    seq->clear();
    std::string line;
    ok = false;
    while (std::getline(in, line)) {
      if (!line.empty() && line[0] == '>') {
        pending = line;
        ok = true;
        break;
      }
      seq->append(line);
    }
    return true;
  }
};

void apply_snps(const std::string& chr_token, std::string* seq,
                const CombPars& p, long long* total, long long* low,
                long long* high) {
  std::ifstream ext("mg-ref-output/SNP.extract.chr" + chr_token + ".data");
  if (!ext.good()) return;
  long long pos, occ;
  char ref, alt;
  while (ext >> pos >> ref >> alt >> occ) {
    if (p.has_min && occ < p.min_occ) { ++*low; continue; }
    if (pos < 1 || pos > static_cast<long long>(seq->size())) continue;
    char& cur = (*seq)[pos - 1];
    if (p.has_max && occ > p.max_occ) {
      // high-frequency SNPs replace the reference base outright
      ++*high;
      cur = alt;
      continue;
    }
    ++*total;
    cur = kMaskChar[char_mask(cur) | char_mask(ref) | char_mask(alt)];
  }
}

void emit_bubbles(const std::string& header_no_gt, const std::string& chr_token,
                  const std::string& seq, const CombPars& p,
                  std::ostream& bubble, std::ostream& data,
                  long long* bubble_id, long long* total) {
  std::ifstream ext("mg-ref-output/INDEL.extract.chr" + chr_token + ".data");
  if (!ext.good()) return;
  long long pos, occ;
  std::string ref, alt;
  long long n = static_cast<long long>(seq.size());
  while (ext >> pos >> ref >> alt >> occ) {
    ++*total;
    long long rlen = static_cast<long long>(ref.size());
    long long A = std::max(pos - p.window, 1LL);
    long long B_minus_A = std::min(p.window, pos - 1);
    long long Cc = pos + rlen;
    long long D_minus_C = std::min(p.window, n + 1 - pos - rlen) - 1;
    long long ref_len = (ref[0] != '.') ? rlen : 0;
    long long alt_len = (alt[0] != '.') ? static_cast<long long>(alt.size()) : 0;

    bubble << ">bubble" << *bubble_id << " " << header_no_gt << " " << A << "\n";
    data << header_no_gt << "\n";
    data << A << "\t" << B_minus_A << "\t" << Cc << "\t" << D_minus_C << "\t"
         << ref_len << "\t" << alt_len << "\n";

    std::string branch;
    for (long long i = std::min(p.window, pos - 1); i > 0; --i)
      branch += seq[pos - i - 1];                       // left pad
    if (alt[0] != '.') branch += alt;                   // the ALT allele
    long long right = std::min(p.window, n + 1 - pos - rlen);
    for (long long i = 0; i < right; ++i)
      branch += seq[pos + rlen + i - 1];                // right pad
    bubble << branch << "\n";
    ++*bubble_id;
  }
}

int run_comb(int argc, char** argv) {
  CombPars pars;
  int argi = 1;
  for (; argi < argc && argv[argi][0] == '-'; ++argi) {
    std::string opt = argv[argi];
    if (argi + 1 >= argc) break;
    if (opt == "-w") pars.window = std::atoll(argv[++argi]);
    else if (opt == "-i") { pars.has_min = true; pars.min_occ = std::atoll(argv[++argi]); }
    else if (opt == "-a") { pars.has_max = true; pars.max_occ = std::atoll(argv[++argi]); }
    else break;
  }
  if (argc - argi < 4) {
    std::fprintf(stderr,
                 "Usage: comb <input.fasta> <output.fasta> "
                 "<output_bubble.fasta> <bubble.data>\n"
                 "Option:  -w INT  window size [default: 124]\n"
                 "         -i INT  minimum occurrence\n"
                 "         -a INT  maximum occurrence\n");
    return 1;
  }
  if (pars.window < 0) {
    std::fprintf(stderr, "window size shouldn't be negative.\n");
    return 1;
  }
  std::string in_fa = argv[argi], out_fa = argv[argi + 1];
  std::string out_bub = argv[argi + 2], out_data = argv[argi + 3];

  // pass 1: fold SNPs into IUPAC codes; both outputs get the SNP genome
  long long total_snp = 0, low_snp = 0, high_snp = 0;
  {
    FastaStream fa(in_fa);
    std::ofstream multifasta(out_fa), bubble(out_bub);
    std::string header, seq;
    while (fa.next(&header, &seq)) {
      std::string tok;
      std::stringstream hs(header);
      hs >> tok;
      tok.erase(tok.begin());  // first token sans '>'
      apply_snps(tok, &seq, pars, &total_snp, &low_snp, &high_snp);
      multifasta << header << "\n";
      bubble << header << "\n";
      write_wrapped(multifasta, seq);
      write_wrapped(bubble, seq);
    }
  }
  std::printf("total snp number is %lld\n", total_snp);
  std::printf("low end snp number is %lld\n", low_snp);
  std::printf("high end snp number is %lld\n", high_snp);

  // pass 2: append one bubble branch per INDEL to the bubble fasta
  long long total_indel = 0, bubble_id = 0;
  {
    FastaStream fa(out_fa);
    std::ofstream bubble(out_bub, std::ios::out | std::ios::app);
    std::ofstream data(out_data);
    std::string header, seq;
    while (fa.next(&header, &seq)) {
      std::string full = header.substr(1);  // header sans '>'
      std::string tok;
      std::stringstream hs(header);
      hs >> tok;
      tok.erase(tok.begin());
      emit_bubbles(full, tok, seq, pars, bubble, data, &bubble_id,
                   &total_indel);
    }
  }
  std::printf("total indel number is %lld\n", total_indel);
  return 0;
}

// ------------------------------------------------------------------ sam_pad

struct Bubble {
  std::string ann;
  long long A, B_minus_A, C, D_minus_C, ref_len, alt_len;
};

int run_sam_pad(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr, "Usage: sam_pad <bubble.data> <sam.input> <sam.output>\n");
    return 1;
  }
  std::vector<Bubble> bubbles;
  {
    std::ifstream in(argv[1]);
    std::string ann, line;
    while (std::getline(in, ann)) {
      if (!std::getline(in, line)) break;
      Bubble b;
      b.ann = ann;
      std::stringstream ls(line);
      ls >> b.A >> b.B_minus_A >> b.C >> b.D_minus_C >> b.ref_len >> b.alt_len;
      bubbles.push_back(b);
    }
  }

  std::ifstream in(argv[2]);
  std::ofstream out(argv[3]);
  std::string line;
  while (std::getline(in, line)) {
    if (!line.empty() && line[0] == '@') {
      out << line << "\n";
      continue;
    }
    std::stringstream ls(line);
    std::string qname, flag, rname, pos;
    std::getline(ls, qname, '\t');
    std::getline(ls, flag, '\t');
    std::getline(ls, rname, '\t');
    std::getline(ls, pos, '\t');

    out << line;
    if (rname.rfind("bubble", 0) == 0) {
      long long which = std::atoll(rname.substr(6).c_str());
      if (which >= 0 && which < static_cast<long long>(bubbles.size())) {
        const Bubble& b = bubbles[which];
        out << "\tbC:Z:" << b.ann << "\tbP:Z:";
        long long locus = std::atoll(pos.c_str());
        if (locus >= 1 && locus <= b.B_minus_A) {
          out << b.A + locus - 1;                      // left pad
        } else if (locus >= b.B_minus_A + b.alt_len + 1 &&
                   locus <= b.B_minus_A + b.alt_len + b.D_minus_C + 1) {
          out << locus + b.C - (b.B_minus_A + b.alt_len + 1);  // right pad
        } else {
          out << b.B_minus_A + b.A << "-"
              << b.B_minus_A + b.A + b.ref_len - 1;    // inside the indel
        }
      }
    }
    out << "\n";
  }
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  const char* base = std::strrchr(argv[0], '/');
  std::string name = base ? base + 1 : argv[0];
  if (name == "data_prep") return run_data_prep(argc, argv);
  if (name == "comb") return run_comb(argc, argv);
  if (name == "sam_pad") return run_sam_pad(argc, argv);
  // multi-call dispatch: mgref <tool> [args...]
  if (argc >= 2) {
    std::string cmd = argv[1];
    if (cmd == "data_prep") return run_data_prep(argc - 1, argv + 1);
    if (cmd == "comb") return run_comb(argc - 1, argv + 1);
    if (cmd == "sam_pad") return run_sam_pad(argc - 1, argv + 1);
  }
  std::fprintf(stderr, "Usage: mgref {data_prep|comb|sam_pad} [args...]\n");
  return 1;
}
