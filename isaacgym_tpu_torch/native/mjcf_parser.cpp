// Native MJCF (MuJoCo XML) asset-loader core (SURVEY.md §2 N3).
//
// Mirrors isaacgym_tpu_torch/models/mjcf.py exactly (that Python parser remains
// the verified fallback; equivalence-tested in tests/test_torch_native.py):
//   * nested <body> tree with pos / quat / euler frames,
//   * one <joint> per body: hinge -> revolute, slide -> prismatic,
//     <freejoint>/none -> welded,
//   * <inertial> (pos, mass, diaginertia / fullinertia),
//   * <geom> sphere / box / cylinder / capsule (as cylinder), fromto,
//   * <default> class inheritance for joint/geom attributes,
//   * joint anchors (<joint pos>) folded into the joint frame the way
//     MuJoCo's own compiler does for reduced coordinates.
//
// Emits the same flattened IgUrdf struct as the URDF core, so the Python
// binding rebuilds a models.urdf.UrdfModel from either format.
//
// Build: see urdf_parser.cpp (both cores link into libig_assets.so).

#include <cmath>
#include <cstdio>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <vector>

#include "ig_asset.h"
#include "xml_mini.h"

using igxml::Child;
using igxml::ParseFloats;
using igxml::XmlNode;
using igxml::XmlParser;

namespace {

constexpr double kPi = 3.14159265358979323846;

struct GeomT {
  int kind;  // 0 sphere, 1 box, 2 cylinder
  double xyz[3], rpy[3], size[3];
};

struct LinkT {
  std::string name;
  double mass = 0.0;
  double com[3] = {0, 0, 0};
  double inertia[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  std::vector<GeomT> geoms;
};

struct JointT {
  std::string name;
  int kind;  // 0 fixed, 1 revolute, 2 prismatic
  int parent, child;
  double xyz[3] = {0, 0, 0}, rpy[3] = {0, 0, 0}, axis[3] = {0, 0, 1};
  double lower = 0, upper = 0, effort = 0, velocity = 0;
  double damping = 0, friction = 0, armature = 0;
};

using AttrMap = std::map<std::string, std::string>;

// xyzw quaternion -> URDF rpy (extrinsic XYZ); matches mjcf._quat_to_rpy
void QuatToRpy(const double q[4], double rpy[3]) {
  double x = q[0], y = q[1], z = q[2], w = q[3];
  double sinr = 2 * (w * x + y * z), cosr = 1 - 2 * (x * x + y * y);
  rpy[0] = std::atan2(sinr, cosr);
  double sinp = 2 * (w * y - z * x);
  rpy[1] = std::fabs(sinp) >= 1 ? std::copysign(kPi / 2, sinp) : std::asin(sinp);
  double siny = 2 * (w * z + x * y), cosy = 1 - 2 * (y * y + z * z);
  rpy[2] = std::atan2(siny, cosy);
}

// pos/quat/euler frame of a raw element -> rpy (mjcf._frame_rpy)
void FrameRpy(const XmlNode& el, double rpy[3]) {
  rpy[0] = rpy[1] = rpy[2] = 0.0;
  auto it = el.attrs.find("quat");
  if (it != el.attrs.end()) {
    double wxyz[4];
    ParseFloats(it->second, wxyz, 4);
    double xyzw[4] = {wxyz[1], wxyz[2], wxyz[3], wxyz[0]};
    QuatToRpy(xyzw, rpy);
    return;
  }
  it = el.attrs.find("euler");
  if (it != el.attrs.end()) ParseFloats(it->second, rpy, 3);  // eulerseq xyz
}

struct MjcfCtx {
  std::map<std::string, std::map<std::string, AttrMap>> defaults;  // cls -> kind -> attrs
  std::vector<LinkT> links;
  std::vector<JointT> joints;
  int counter = 0;
  std::string err;

  void CollectDefaults(const XmlNode& d, const std::string& parent_cls) {
    std::string cls = d.attrs.count("class") ? d.attrs.at("class") : parent_cls;
    std::map<std::string, AttrMap> entry;
    for (const char* kind : {"joint", "geom"}) {
      AttrMap base;
      auto pit = defaults.find(parent_cls);
      if (pit != defaults.end() && pit->second.count(kind))
        base = pit->second.at(kind);
      if (const XmlNode* el = Child(d, kind))
        for (const auto& kv : el->attrs) base[kv.first] = kv.second;
      entry[kind] = base;
    }
    defaults[cls] = entry;
    for (const auto& sub : d.children)
      if (sub.tag == "default") CollectDefaults(sub, cls);
  }

  AttrMap Merged(const XmlNode& el, const char* kind) const {
    std::string cls = el.attrs.count("class") ? el.attrs.at("class") : "";
    AttrMap base;
    auto rit = defaults.find("");
    if (rit != defaults.end() && rit->second.count(kind)) base = rit->second.at(kind);
    auto cit = defaults.find(cls);
    if (cit != defaults.end() && cit->second.count(kind))
      for (const auto& kv : cit->second.at(kind)) base[kv.first] = kv.second;
    for (const auto& kv : el.attrs) base[kv.first] = kv.second;
    return base;
  }

  static std::string Get(const AttrMap& a, const char* key, const char* def = "") {
    auto it = a.find(key);
    return it == a.end() ? std::string(def) : it->second;
  }

  // mjcf.geom_of: returns false for non-primitive geoms (plane/mesh)
  bool GeomOf(const XmlNode& el, GeomT* out) {
    AttrMap a = Merged(el, "geom");
    std::string gtype = Get(a, "type", "sphere");
    double size[3];
    ParseFloats(Get(a, "size"), size, 3);
    ParseFloats(Get(a, "pos"), out->xyz, 3);
    FrameRpy(el, out->rpy);  // raw element frame, same as the Python parser
    if (gtype == "sphere") {
      out->kind = 0;
      out->size[0] = size[0]; out->size[1] = 0.0; out->size[2] = 0.0;
      return true;
    }
    if (gtype == "box") {  // MJCF sizes are half-extents already
      out->kind = 1;
      for (int k = 0; k < 3; k++) out->size[k] = size[k];
      return true;
    }
    if (gtype == "cylinder" || gtype == "capsule") {
      out->kind = 2;
      double half_len = size[1];
      std::string fromto = Get(a, "fromto");
      if (!fromto.empty()) {
        double ft[6];
        ParseFloats(fromto, ft, 6);
        double d[3] = {ft[3] - ft[0], ft[4] - ft[1], ft[5] - ft[2]};
        double n = std::sqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
        for (int k = 0; k < 3; k++) out->xyz[k] = (ft[k] + ft[3 + k]) / 2.0;
        half_len = n / 2.0;
        double nn = n > 1e-9 ? n : 1e-9;
        double dz = d[2] / nn;
        if (dz > 1.0) dz = 1.0;
        if (dz < -1.0) dz = -1.0;
        out->rpy[0] = 0.0;
        out->rpy[1] = std::acos(dz);
        out->rpy[2] = std::atan2(d[1] / nn, d[0] / nn);
      }
      out->size[0] = size[0]; out->size[1] = half_len; out->size[2] = 0.0;
      return true;
    }
    return false;
  }

  // returns link index, or -1 on error
  int Walk(const XmlNode& body_el, int parent_idx) {
    std::string name = body_el.attrs.count("name")
                           ? body_el.attrs.at("name")
                           : "body_" + std::to_string(counter);
    counter++;
    int li = static_cast<int>(links.size());
    links.emplace_back();
    // NOTE: never hold a LinkT& across Walk recursion — the vector may
    // reallocate; always re-index through links[li]
    links[li].name = name;

    if (const XmlNode* inertial = Child(body_el, "inertial")) {
      links[li].mass = inertial->attrs.count("mass")
                           ? std::atof(inertial->attrs.at("mass").c_str())
                           : 0.0;
      if (inertial->attrs.count("pos"))
        ParseFloats(inertial->attrs.at("pos"), links[li].com, 3);
      if (inertial->attrs.count("fullinertia")) {
        double fi[6];
        ParseFloats(inertial->attrs.at("fullinertia"), fi, 6);
        double* I = links[li].inertia;
        I[0] = fi[0]; I[1] = fi[3]; I[2] = fi[4];
        I[3] = fi[3]; I[4] = fi[1]; I[5] = fi[5];
        I[6] = fi[4]; I[7] = fi[5]; I[8] = fi[2];
      } else if (inertial->attrs.count("diaginertia")) {
        double di[3];
        ParseFloats(inertial->attrs.at("diaginertia"), di, 3);
        links[li].inertia[0] = di[0];
        links[li].inertia[4] = di[1];
        links[li].inertia[8] = di[2];
      }
    }
    for (const auto& c : body_el.children) {
      if (c.tag != "geom") continue;
      GeomT g;
      if (GeomOf(c, &g)) links[li].geoms.push_back(g);
    }

    std::vector<const XmlNode*> joint_els;
    for (const auto& c : body_el.children)
      if (c.tag == "joint") joint_els.push_back(&c);
    bool free = Child(body_el, "freejoint") != nullptr;

    double shift[3] = {0, 0, 0};
    if (parent_idx >= 0) {
      double xyz[3], rpy[3];
      ParseFloats(body_el.attrs.count("pos") ? body_el.attrs.at("pos") : "", xyz, 3);
      FrameRpy(body_el, rpy);
      if (joint_els.size() > 1) {
        err = "body " + name + ": multiple joints per body are not supported";
        return -1;
      }
      if (!joint_els.empty() && !free) {
        AttrMap a = Merged(*joint_els[0], "joint");
        std::string jtype = Get(a, "type", "hinge");
        int kind;
        if (jtype == "hinge") kind = 1;
        else if (jtype == "slide") kind = 2;
        else { err = "joint type " + jtype; return -1; }
        double jpos[3];
        ParseFloats(Get(a, "pos"), jpos, 3);
        if (std::fabs(jpos[0]) > 0 || std::fabs(jpos[1]) > 0 || std::fabs(jpos[2]) > 0) {
          // fold the anchor into the joint frame (MuJoCo compiles it away)
          for (int k = 0; k < 3; k++) {
            xyz[k] += jpos[k];
            links[li].com[k] -= jpos[k];
          }
          for (auto& g : links[li].geoms)
            for (int k = 0; k < 3; k++) g.xyz[k] -= jpos[k];
          for (int k = 0; k < 3; k++) shift[k] = jpos[k];
        }
        double rng[2];
        ParseFloats(Get(a, "range"), rng, 2);
        bool has_range = !Get(a, "range").empty();
        std::string limited = Get(a, "limited", has_range ? "true" : "false");
        double lower = -kPi, upper = kPi;
        if (limited == "true" || has_range) { lower = rng[0]; upper = rng[1]; }
        JointT j;
        j.name = !Get(a, "name").empty() ? Get(a, "name") : name + "_joint";
        j.kind = kind;
        j.parent = parent_idx;
        j.child = li;
        for (int k = 0; k < 3; k++) { j.xyz[k] = xyz[k]; j.rpy[k] = rpy[k]; }
        double axis[3] = {0, 0, 1};
        ParseFloats(Get(a, "axis", "0 0 1"), axis, 3);
        for (int k = 0; k < 3; k++) j.axis[k] = axis[k];
        j.lower = lower;
        j.upper = upper;
        std::string afr = Get(a, "actuatorfrcrange");
        if (!afr.empty()) {
          // last whitespace token (mjcf.py: .split()[-1])
          std::istringstream ss(afr);
          std::string tok, last;
          while (ss >> tok) last = tok;
          j.effort = std::atof(last.c_str());
        } else {
          j.effort = 100.0;
        }
        j.velocity = 50.0;
        j.damping = std::atof(Get(a, "damping", "0").c_str());
        j.friction = std::atof(Get(a, "frictionloss", "0").c_str());
        j.armature = std::atof(Get(a, "armature", "0").c_str());
        joints.push_back(j);
      } else {
        JointT j;
        j.name = name + "_weld";
        j.kind = 0;
        j.parent = parent_idx;
        j.child = li;
        for (int k = 0; k < 3; k++) { j.xyz[k] = xyz[k]; j.rpy[k] = rpy[k]; }
        joints.push_back(j);
      }
    }

    // child bodies' pos is relative to the unshifted parent frame
    for (const auto& child_el : body_el.children) {
      if (child_el.tag != "body") continue;
      size_t child_joint_idx = joints.size();  // child's connecting joint is
      if (Walk(child_el, li) < 0) return -1;   // appended first in its walk
      if (std::fabs(shift[0]) > 0 || std::fabs(shift[1]) > 0 || std::fabs(shift[2]) > 0)
        for (int k = 0; k < 3; k++) joints[child_joint_idx].xyz[k] -= shift[k];
    }
    return li;
  }
};

}  // namespace

extern "C" {

IgUrdf* ig_parse_mjcf(const char* path, char* errbuf, int errlen) {
  std::ifstream f(path);
  if (!f) {
    std::snprintf(errbuf, errlen, "cannot open %s", path);
    return nullptr;
  }
  std::stringstream buf;
  buf << f.rdbuf();
  std::string text = buf.str();

  XmlNode root;
  std::string err;
  XmlParser parser(text);
  if (!parser.Parse(&root, &err) || root.tag != "mujoco") {
    std::snprintf(errbuf, errlen, "parse error: %s",
                  root.tag != "mujoco" && err.empty() ? "root tag is not <mujoco>"
                                                      : err.c_str());
    return nullptr;
  }

  MjcfCtx ctx;
  for (const auto& d : root.children)
    if (d.tag == "default") ctx.CollectDefaults(d, "");

  const XmlNode* worldbody = Child(root, "worldbody");
  if (!worldbody) {
    std::snprintf(errbuf, errlen, "MJCF has no <worldbody>");
    return nullptr;
  }
  std::vector<const XmlNode*> top;
  for (const auto& b : worldbody->children)
    if (b.tag == "body") top.push_back(&b);
  if (top.empty()) {
    std::snprintf(errbuf, errlen, "MJCF worldbody has no bodies");
    return nullptr;
  }

  if (top.size() == 1) {
    if (ctx.Walk(*top[0], -1) < 0) {
      std::snprintf(errbuf, errlen, "%s", ctx.err.c_str());
      return nullptr;
    }
  } else {
    // multiple top-level bodies: weld them to a synthetic world link
    ctx.links.emplace_back();
    ctx.links.back().name = "world";
    for (const XmlNode* b : top) {
      if (ctx.Walk(*b, 0) < 0) {
        std::snprintf(errbuf, errlen, "%s", ctx.err.c_str());
        return nullptr;
      }
    }
  }

  int nL = static_cast<int>(ctx.links.size());
  int nJ = static_cast<int>(ctx.joints.size());
  int nG = 0;
  for (const auto& l : ctx.links) nG += static_cast<int>(l.geoms.size());

  IgUrdf* u = IgAlloc(nL, nJ, nG);
  auto mit = root.attrs.find("model");
  u->robot_name = IgDup(mit == root.attrs.end() ? "mjcf_robot" : mit->second);

  int gi = 0;
  for (int i = 0; i < nL; i++) {
    const LinkT& l = ctx.links[i];
    u->link_names[i] = IgDup(l.name);
    u->link_mass[i] = l.mass;
    for (int k = 0; k < 3; k++) u->link_com[i * 3 + k] = l.com[k];
    for (int k = 0; k < 9; k++) u->link_inertia[i * 9 + k] = l.inertia[k];
    for (const auto& g : l.geoms) {
      u->geom_link[gi] = i;
      u->geom_kind[gi] = g.kind;
      for (int k = 0; k < 3; k++) {
        u->geom_origin[gi * 6 + k] = g.xyz[k];
        u->geom_origin[gi * 6 + 3 + k] = g.rpy[k];
        u->geom_size[gi * 3 + k] = g.size[k];
      }
      gi++;
    }
  }
  for (int j = 0; j < nJ; j++) {
    const JointT& jt = ctx.joints[j];
    u->joint_names[j] = IgDup(jt.name);
    u->joint_kind[j] = jt.kind;
    u->joint_parent[j] = jt.parent;
    u->joint_child[j] = jt.child;
    for (int k = 0; k < 3; k++) {
      u->joint_origin[j * 6 + k] = jt.xyz[k];
      u->joint_origin[j * 6 + 3 + k] = jt.rpy[k];
      u->joint_axis[j * 3 + k] = jt.axis[k];
    }
    u->joint_limit[j * 4 + 0] = jt.lower;
    u->joint_limit[j * 4 + 1] = jt.upper;
    u->joint_limit[j * 4 + 2] = jt.effort;
    u->joint_limit[j * 4 + 3] = jt.velocity;
    u->joint_dynamics[j * 3 + 0] = jt.damping;
    u->joint_dynamics[j * 3 + 1] = jt.friction;
    u->joint_dynamics[j * 3 + 2] = jt.armature;
  }
  return u;
}

}  // extern "C"
