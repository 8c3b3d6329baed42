// Minimal XML parser shared by the native asset-loader cores (URDF + MJCF;
// SURVEY.md §2 N3). Elements + attributes only — sufficient for robot
// description files; no namespaces, CDATA, or DTD handling.
#ifndef ISAACGYM_TPU_NATIVE_XML_MINI_H_
#define ISAACGYM_TPU_NATIVE_XML_MINI_H_

#include <cctype>
#include <cstdlib>
#include <map>
#include <sstream>
#include <string>
#include <vector>

namespace igxml {

struct XmlNode {
  std::string tag;
  std::map<std::string, std::string> attrs;
  std::vector<XmlNode> children;
};

class XmlParser {
 public:
  explicit XmlParser(const std::string& text) : s_(text), pos_(0) {}

  bool Parse(XmlNode* root, std::string* err) {
    SkipProlog();
    return ParseElement(root, err);
  }

 private:
  void SkipWs() {
    while (pos_ < s_.size() && std::isspace(static_cast<unsigned char>(s_[pos_]))) pos_++;
  }

  void SkipProlog() {
    for (;;) {
      SkipWs();
      if (s_.compare(pos_, 2, "<?") == 0) {
        size_t e = s_.find("?>", pos_);
        pos_ = (e == std::string::npos) ? s_.size() : e + 2;
      } else if (s_.compare(pos_, 4, "<!--") == 0) {
        size_t e = s_.find("-->", pos_);
        pos_ = (e == std::string::npos) ? s_.size() : e + 3;
      } else {
        return;
      }
    }
  }

  bool ParseName(std::string* out) {
    size_t start = pos_;
    while (pos_ < s_.size() &&
           (std::isalnum(static_cast<unsigned char>(s_[pos_])) || s_[pos_] == '_' ||
            s_[pos_] == '-' || s_[pos_] == ':' || s_[pos_] == '.')) {
      pos_++;
    }
    if (pos_ == start) return false;
    out->assign(s_, start, pos_ - start);
    return true;
  }

  bool ParseElement(XmlNode* node, std::string* err) {
    SkipProlog();
    if (pos_ >= s_.size() || s_[pos_] != '<') {
      *err = "expected '<'";
      return false;
    }
    pos_++;  // '<'
    if (!ParseName(&node->tag)) {
      *err = "bad tag name";
      return false;
    }
    // attributes
    for (;;) {
      SkipWs();
      if (pos_ >= s_.size()) {
        *err = "unexpected eof in tag";
        return false;
      }
      if (s_[pos_] == '/') {  // self-closing
        pos_++;
        if (pos_ < s_.size() && s_[pos_] == '>') {
          pos_++;
          return true;
        }
        *err = "bad self-close";
        return false;
      }
      if (s_[pos_] == '>') {
        pos_++;
        break;
      }
      std::string key;
      if (!ParseName(&key)) {
        *err = "bad attr name in <" + node->tag + ">";
        return false;
      }
      SkipWs();
      if (pos_ >= s_.size() || s_[pos_] != '=') {
        *err = "expected '=' after attr " + key;
        return false;
      }
      pos_++;
      SkipWs();
      char quote = s_[pos_];
      if (quote != '"' && quote != '\'') {
        *err = "expected quote";
        return false;
      }
      pos_++;
      size_t end = s_.find(quote, pos_);
      if (end == std::string::npos) {
        *err = "unterminated attr value";
        return false;
      }
      node->attrs[key] = s_.substr(pos_, end - pos_);
      pos_ = end + 1;
    }
    // children / text until </tag>
    for (;;) {
      SkipProlog();
      if (pos_ >= s_.size()) {
        *err = "unexpected eof in <" + node->tag + ">";
        return false;
      }
      if (s_[pos_] == '<') {
        if (s_.compare(pos_, 2, "</") == 0) {
          pos_ += 2;
          std::string close;
          ParseName(&close);
          SkipWs();
          if (pos_ < s_.size() && s_[pos_] == '>') pos_++;
          if (close != node->tag) {
            *err = "mismatched close tag " + close + " for " + node->tag;
            return false;
          }
          return true;
        }
        node->children.emplace_back();
        if (!ParseElement(&node->children.back(), err)) return false;
      } else {
        pos_++;  // skip text content
      }
    }
  }

  const std::string& s_;
  size_t pos_;
};

inline void ParseFloats(const std::string& text, double* out, int n, double def = 0.0) {
  for (int i = 0; i < n; i++) out[i] = def;
  std::istringstream ss(text);
  for (int i = 0; i < n; i++) {
    if (!(ss >> out[i])) break;
  }
}

inline double AttrF(const XmlNode& n, const char* key, double def = 0.0) {
  auto it = n.attrs.find(key);
  return it == n.attrs.end() ? def : std::atof(it->second.c_str());
}

inline const XmlNode* Child(const XmlNode& n, const char* tag) {
  for (const auto& c : n.children)
    if (c.tag == tag) return &c;
  return nullptr;
}

}  // namespace igxml

#endif  // ISAACGYM_TPU_NATIVE_XML_MINI_H_
